"""The Vocos decoder's backbone on channels-last activations
(`models/vocos_backbone.py`, `csrc/vocos_backbone.cu`).

On the CPU: the packed weights' layout and TF32 split, the split-TF32
products against float64, the decoder's choice of path (the CPU and
autograd keep the modules, and the gradient reaches every parameter), the
widths the kernels refuse, and the wrappers refusing the CPU (the packed
weights' lifetime is held in tests/test_torch_derived.py). On the card (`-m cuda`): the kernels against the module
path in f32 with TF32 off at the batch cell's shapes and at the smallest
(one frame refused on both paths), with and without a speaker, within 1e-5
of the largest magnitude and under a twentieth of a single TF32 pass's
gap; the audio within 2e-6; each row of a batch equal to the row decoded
alone; the launches of one decode; a decoder of other widths refused, not
sent to the modules. Imports nothing of JAX; on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_vocos_backbone.py
"""

import numpy as np
import pytest
import torch

from wetts_tpu_torch.models import vocos_backbone as vb
from wetts_tpu_torch.models.mrf import round_tf32, split_tf32
from wetts_tpu_torch.models.vocos import VocosGenerator
from wetts_tpu_torch.tools.probe_vocos import random_decoder
from wetts_tpu_torch.utils.profiling import StageTimes

# tiny widths that leave every tile ragged: K of 20, 24 and 40 (no multiple
# of a packed chunk of 32), N of 24, 40 and 66 (below a 128-channel tile; 66
# no multiple of 4)
TINY = dict(in_channels=20, channels=24, h_channels=40, out_channels=66,
            num_layers=2, istft_n_fft=64, istft_hop_length=16,
            istft_win_length=64)


def tiny_decoder(gin_channels: int = 8, seed: int = 0) -> VocosGenerator:
    torch.manual_seed(seed)
    dec = VocosGenerator(**TINY, gin_channels=gin_channels)
    with torch.no_grad():
        for p in dec.parameters():
            fan_in = p.numel() // p.shape[0] if p.ndim > 1 else p.numel()
            p.copy_((torch.rand(p.shape) * 2 - 1) * fan_in ** -0.5)
    return dec


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def unpack_weight(p: torch.Tensor, n: int, k: int):
    """`vb.pack_weight`'s inverse: its (hi, lo) parts as [n, k] each."""
    nt, kc = p.shape[:2]
    inverse = torch.argsort(torch.tensor(vb.K_ORDER, device=p.device))
    parts = vb._swizzle(p).permute(2, 0, 3, 1, 4, 5).reshape(
        2, nt * vb.TILE_N, kc, vb.CHUNK_K)[..., inverse]
    parts = parts.reshape(2, nt * vb.TILE_N, kc * vb.CHUNK_K)
    return parts[0, :n, :k], parts[1, :n, :k]


def gemm_split_tf32_reference(x: torch.Tensor, packed: torch.Tensor,
                              n: int) -> torch.Tensor:
    """The kernel's products in plain PyTorch: x [M, K] split into TF32
    parts against the packed parts, hi*lo + lo*hi + hi*hi in f32."""
    wh, wl = unpack_weight(packed, n, x.shape[1])
    xh, xl = split_tf32(x)
    return xh @ wl.T + xl @ wh.T + xh @ wh.T


@pytest.mark.parametrize("n,k", [(66, 20), (40, 24), (512, 1536),
                                 (1026, 512)])
def test_packed_layout(n, k):
    w = torch.randn(n, k, generator=torch.Generator().manual_seed(n + k))
    p = vb.pack_weight(w)
    n_tiles, k_chunks = -(-n // vb.TILE_N), -(-k // vb.CHUNK_K)
    assert p.shape == (n_tiles, k_chunks, 2, vb.TILE_N, 8, 4)
    hi, lo = unpack_weight(p, n, k)
    assert torch.equal(hi, split_tf32(w)[0]) and torch.equal(lo,
                                                             split_tf32(w)[1])
    # element (channel, k): [tile][chunk][part][channel][16-byte chunk of
    # the row, swizzled by the channel's row in its 8-row atom][4], K in
    # the products' order
    assert sorted(vb.K_ORDER) == list(range(vb.CHUNK_K))
    for ch, kk in ((0, 0), (n - 1, k - 1), (n // 2, k // 3), (9, 5)):
        at = vb.K_ORDER.index(kk % vb.CHUNK_K)
        stored = (at // 4) ^ (ch % 8)
        assert p[ch // vb.TILE_N, kk // vb.CHUNK_K, 0, ch % vb.TILE_N, stored,
                 at % 4] == hi[ch, kk]
    # K step t, column c of a chunk: thread c % 4's pair t, first or second
    assert vb.K_ORDER[:8] == (0, 8, 16, 24, 1, 9, 17, 25)
    # zeros past N and K
    full = torch.stack(unpack_weight(p, n_tiles * vb.TILE_N,
                                        k_chunks * vb.CHUNK_K))
    assert not full[:, n:].any() and not full[:, :, k:].any()


def test_split_tf32_products_keep_f32():
    """The split the kernel takes of every operand: both parts TF32
    values summing to v within 2^-21 |v|; the three products within 1e-6
    of float64, a single TF32 pass far outside."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(64, 512, generator=gen)
    w = torch.randn(96, 512, generator=gen) / 512 ** 0.5
    for v in (x, w):
        hi, lo = split_tf32(v)
        assert torch.equal(hi, round_tf32(v))
        assert torch.equal(lo, round_tf32(lo))
        assert ((hi + lo - v).abs() <= 2.0 ** -21 * v.abs()).all()
    want = x.double() @ w.double().T
    got = gemm_split_tf32_reference(x, vb.pack_weight(w), 96)
    single = round_tf32(x) @ round_tf32(w).T
    scale = want.abs().max().item()
    assert (got.double() - want).abs().max().item() < 1e-6 * scale
    # a single TF32 pass is some thousand times further off
    assert (single.double() - want).abs().max().item() > 1e-4 * scale


@pytest.mark.parametrize("widths,what", [
    (dict(in_channels=18), "input widths that are multiples of 4, not 18"),
    (dict(channels=26), "LayerNorm widths that are multiples of 4, not 26"),
    (dict(h_channels=42), "hidden widths that are multiples of 4, not 42"),
    (dict(channels=1028), "LayerNorms of at most 1024 channels, not 1028")])
def test_widths_the_kernels_refuse(widths, what):
    """Said in a ValueError, on the card as here: never sent to the
    modules without a word."""
    dec = VocosGenerator(**{**TINY, **widths})
    with pytest.raises(ValueError, match=what):
        vb.check_widths(dec)
    with torch.no_grad(), pytest.raises(ValueError, match=what):
        vb.backbone(dec, torch.randn(1, dec.in_conv.weight.shape[1], 4),
                    None)


def test_widths_the_kernels_take():
    """Any output width (TINY's 66 is no multiple of 4) and the
    published ones."""
    vb.check_widths(tiny_decoder())
    vb.check_widths(VocosGenerator(
        in_channels=192, channels=512, h_channels=1536, out_channels=1026,
        num_layers=1))


@pytest.mark.parametrize("wrapper", ["gemm", "rownorm", "backbone"])
def test_wrappers_refuse_the_cpu(wrapper):
    """The kernels are the card's alone: the CPU decodes on the modules."""
    dec = tiny_decoder()
    x = torch.randn(6, TINY["channels"])
    with torch.no_grad(), pytest.raises(ValueError, match="card"):
        if wrapper == "gemm":
            conv = dec.layers[0].pw_conv1
            vb.gemm(x, conv.weight[:, :, 0], vb.pack_weight(
                conv.weight[:, :, 0]), conv.bias)
        elif wrapper == "rownorm":
            vb.rownorm(x, 3, dec.norm_pre)
        else:
            vb.backbone(dec, x.T[None, :TINY["in_channels"]], None)


def test_one_frame_is_refused_on_both_paths():
    dec = tiny_decoder()
    x = torch.randn(1, TINY["in_channels"], 1)
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="Padding size"):
            dec.backbone_modules(x)
        with pytest.raises(ValueError, match="at least 2 frames"):
            vb.backbone(dec, x, None)


def test_training_and_the_cpu_keep_the_module_path():
    """A training-mode forward and backward on the CPU: the module path
    runs, the gradient reaches every parameter and no decode counts as
    fused; under no_grad the CPU still takes the modules."""
    dec = tiny_decoder().train()
    x = torch.randn(2, TINY["in_channels"], 12, requires_grad=True)
    g = torch.randn(2, 8, 1)
    st = StageTimes()
    assert not vb.applies(dec, x)
    audio = dec(x, g, stages=st)
    audio.square().mean().backward()
    for name, p in dec.named_parameters():
        assert p.grad is not None and p.grad.abs().sum() > 0, name
    assert x.grad is not None
    with torch.no_grad():
        assert not vb.applies(dec, x)
        dec.eval()(x, g, stages=st)
    rep = st.report()["vocos_fused"]
    assert rep["n"] == 2 and rep["count"] == 0
    assert vb.gemm.launches == 0 and vb.rownorm.launches == 0


# ---- on the card -----------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the backbone kernels have "
                    "no CPU mode")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield random_decoder()
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def card_inputs(rows: int, frames: int, with_g: bool):
    """Rows of different content: channels-last z [rows, frames, 192] and
    g [rows, 256, 1] or None."""
    gen = torch.Generator(device="cuda").manual_seed(rows * 7919 + frames)
    z = torch.randn(rows, frames, 192, device="cuda", generator=gen)
    z = z * torch.linspace(0.5, 1.5, rows, device="cuda")[:, None, None]
    g = (torch.randn(rows, 256, 1, device="cuda", generator=gen)
         if with_g else None)
    return z, g


def module_audio(dec, x, g):
    """The decoder's audio on the module path (autograd recording)."""
    with torch.enable_grad():
        return dec(x, g).detach()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,frames", [(8, 1153), (8, 705), (3, 97),
                                         (1, 2), (1, 1)])
@pytest.mark.parametrize("with_g", [True, False])
def test_kernels_match_the_module_path(card, rows, frames, with_g):
    """Latent frames as the decoder takes them (the backbone runs over one
    more); one frame is refused on both paths, by the reflection pad."""
    dec = card
    z, g = card_inputs(rows, frames, with_g)
    x = z.transpose(1, 2)
    if frames < 2:
        with torch.inference_mode(), pytest.raises(
                ValueError, match="at least 2 frames"):
            dec(x, g)
        with pytest.raises(RuntimeError, match="Padding size"):
            module_audio(dec, x, g)
        return
    with torch.inference_mode():
        assert vb.applies(dec, x)
        want = dec.backbone_modules(x, g).transpose(1, 2)
        got = vb.backbone(dec, x, g)
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = dec.backbone_modules(x, g).transpose(1, 2)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        audio = dec(x, g)
    gap, gap_tf32 = rel_gap(got, want), rel_gap(tf32, want)
    assert gap <= 1e-5, (gap, gap_tf32)
    assert gap < gap_tf32 / 20, (gap, gap_tf32)
    want_audio = module_audio(dec, x, g)
    assert audio.shape == want_audio.shape == (rows, 1, frames * 256)
    assert (audio - want_audio).abs().max().item() <= 2e-6


@pytest.mark.cuda
def test_each_row_decodes_as_alone(card):
    """Rows of different content: each row of the batch's backbone output
    and audio is that row's decoded alone, so the depthwise conv reads no
    neighbour's frames."""
    dec = card
    z, g = card_inputs(3, 97, True)
    with torch.inference_mode():
        batch = vb.backbone(dec, z.transpose(1, 2), g)
        audio = dec(z.transpose(1, 2), g)
        for i in range(3):
            alone = vb.backbone(dec, z[i:i + 1].transpose(1, 2),
                                g[i:i + 1])
            assert rel_gap(batch[i:i + 1], alone) <= 1e-5
            one = dec(z[i:i + 1].transpose(1, 2), g[i:i + 1])
            assert (audio[i:i + 1] - one).abs().max().item() <= 2e-6


@pytest.mark.cuda
def test_one_decode_launches_and_counts(card):
    dec = card
    z, g = card_inputs(2, 40, True)
    st = StageTimes()
    before = (vb.gemm.launches, vb.rownorm.launches)
    with torch.inference_mode():
        dec(z.transpose(1, 2), g, stages=st)
    assert (vb.gemm.launches - before[0],
            vb.rownorm.launches - before[1]) == (2 * 8 + 2, 8 + 2)
    with torch.enable_grad():
        dec(z.transpose(1, 2), g, stages=st)
    rep = st.report()
    assert rep["vocos_fused"]["n"] == 2 and rep["vocos_fused"]["count"] == 1
    np.testing.assert_array_equal(
        [rep["vocos"]["n"], rep["istft"]["n"]], [2, 2])


@pytest.mark.cuda
def test_other_widths_are_refused_on_the_card(card):
    """A decoder of widths the kernels do not take says so at its first
    decode on the card; its module path (autograd on) still runs."""
    dec = VocosGenerator(**{**TINY, "h_channels": 42}).cuda().eval()
    x = torch.randn(1, TINY["in_channels"], 8, device="cuda")
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="hidden widths"):
        dec(x)
    with torch.enable_grad():
        assert dec(x).shape == (1, 1, 8 * TINY["istft_hop_length"])
