"""The kernels on the card: K1, the CUDA MRF kernel (f32 and bf16), against
its plain PyTorch version at VITS-base stage shapes; K2, the CUDA monotonic
alignment search, exactly equal to its plain version; the int8 convolutions
and the int8 MRF stage against their plain versions; K3, the int8 and bf16
matrix chains; the port's synthesis (f32, bf16, int8) and training step
on the GPU against the CPU; and K1 and the int8 stage at the streamed
decoder's chunk shapes, and a streamed synthesis whose batched tail equals
its per-chunk decode on the card at each precision; the Vocos decoder's
iSTFT at any batch size; `cli.model.Model` on a bundle, GPU against CPU;
a bf16 training step with the WavLM discriminator (K2 on f32 scores, f32
master state, within 0.15 of the f32 step), the eval media's decode
after weight updates through K1 against the live weights' plain decode,
and K1 as the registered operator that exported graphs call.

Needs an NVIDIA GPU with nvcc; skips elsewhere (a CUDA kernel has no CPU
mode). Imports nothing of JAX, so on a machine without JAX run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

f32 on both sides with TF32 off (cuDNN would otherwise run the plain
version's convolutions in TF32).
"""

import numpy as np
import pytest
import torch

from chip_smoke import kernels_per_call, phase_train_reference, random_init_
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.mrf import (
    KERNEL_TAPS,
    mrf_conv,
    mrf_conv_reference,
    mrf_stage,
    mrf_stage_int8,
    mrf_stage_int8_reference,
    mrf_stage_reference,
    quantize_stage,
)
from wetts_tpu_torch.models.quant import (
    QuantConv1d,
    QuantConvTranspose1d,
    int8_conv1d,
    int8_conv1d_reference,
    int8_conv_transpose1d,
    int8_conv_transpose1d_reference,
    pack_int8_weight,
    row_scale,
    row_scale_reference,
)
from wetts_tpu_torch.ops.int8_chain import (
    matmul_chain,
    matmul_chain_reference,
)
from wetts_tpu_torch.models.synthesizer import Synthesizer
from wetts_tpu_torch.ops.mas import maximum_path, maximum_path_reference

pytestmark = pytest.mark.cuda

KERNEL_SIZES, DILATIONS = (3, 7, 11), ((1, 3, 5),) * 3  # v1 resblocks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        saved


def _stage(c, kind, gen):
    convs_per_d = 2 if kind == "1" else 1
    return [[(torch.randn(c, c, k, generator=gen) / (c * k) ** 0.5,
              torch.randn(c, generator=gen) * 0.1)
             for _ in range(len(d) * convs_per_d)]
            for k, d in zip(KERNEL_SIZES, DILATIONS)]


@pytest.mark.parametrize("c,t", [(256, 768), (128, 6144), (64, 12288),
                                 (32, 24576), (256, 777), (32, 1001),
                                 (16, 513), (8, 37)])
@pytest.mark.parametrize("kind", ["1", "2"])
def test_mrf_kernel_matches_plain(cuda, c, t, kind):
    """v1 stage widths at a 96-frame bucket, batch 2, then lengths that are
    no multiple of a tile, narrow widths (C = 16 and 8 are padded to the
    instruction's depth) and a length below the widest halo (50); max
    |kernel - plain| <= 1e-4 * max(1, max |plain|): f32 sums of up to C*k
    products taken in another order, from operands split into TF32 parts."""
    gen = torch.Generator().manual_seed(c)
    stage = [[(w.to(cuda), b.to(cuda)) for w, b in br]
             for br in _stage(c, kind, gen)]
    h = torch.randn(2, t, c, generator=gen).to(cuda)
    before = mrf_stage.launches
    got = mrf_stage(h, stage, kind, KERNEL_SIZES, DILATIONS)
    torch.cuda.synchronize()
    assert mrf_stage.launches - before == 9 * (2 if kind == "1" else 1)
    want = mrf_stage_reference(h, stage, kind, KERNEL_SIZES, DILATIONS)
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["1", "2"])
def test_mrf_stage_operator_is_the_launcher(cuda, kind, dtype):
    """`mrf_stage_op`, the stage as `torch.ops.wetts_tpu_torch.mrf_stage`
    (what an exported decoder calls), launches K1 as `mrf_stage` does, with
    equal outputs, packed weights given or not, and traces under
    torch.export to one node that still launches it."""
    from wetts_tpu_torch.models.mrf import mrf_stage_as_op, pack_stage

    gen = torch.Generator().manual_seed(7)
    stage = [[(w.to(cuda, dtype), b.to(cuda, dtype)) for w, b in br]
             for br in _stage(64, kind, gen)]
    h = torch.randn(2, 700, 64, generator=gen).to(cuda, dtype)
    want = mrf_stage(h, stage, kind, KERNEL_SIZES, DILATIONS)
    before = mrf_stage.launches
    for packed in (None, pack_stage(stage)):
        got = mrf_stage_as_op(h, stage, kind, KERNEL_SIZES, DILATIONS,
                              packed)
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert mrf_stage.launches - before == 2 * 9 * (2 if kind == "1" else 1)

    class Stage(torch.nn.Module):
        def forward(self, x):
            return mrf_stage_as_op(x, stage, kind, KERNEL_SIZES, DILATIONS)

    ep = torch.export.export(Stage(), (h,))
    assert [n.target for n in ep.graph.nodes if n.op == "call_function"] \
        == [torch.ops.wetts_tpu_torch.mrf_stage.default]
    assert torch.equal(ep.module()(h), want)


def test_mrf_kernel_refuses_what_it_cannot_run(cuda):
    gen = torch.Generator().manual_seed(0)
    stage = [[(w.to(cuda), b.to(cuda)) for w, b in br]
             for br in _stage(6, "2", gen)]
    with pytest.raises(ValueError):  # C % 4 != 0
        mrf_stage(torch.zeros(1, 40, 6, device=cuda), stage, "2",
                  KERNEL_SIZES, DILATIONS)
    with pytest.raises(ValueError):  # not f32
        mrf_stage(torch.zeros(1, 40, 6, device=cuda, dtype=torch.float16),
                  stage, "2", KERNEL_SIZES, DILATIONS)
    stage = [[(torch.zeros(8, 8, 13, device=cuda),
               torch.zeros(8, device=cuda))]]
    with pytest.raises(ValueError):  # the wrapper takes HiFi-GAN's tap counts
        mrf_stage(torch.zeros(1, 40, 8, device=cuda), stage, "2", (13,),
                  ((1,),))


def test_infer_on_gpu_matches_cpu(cuda):
    """Synthesizer.infer through the kernel on the GPU against the plain
    path on the CPU, small config, scales (0, 1, 0); atol 2e-4."""
    cfg = Config.from_dict({
        "train": {"segment_size": 256},
        "data": {"filter_length": 64, "hop_length": 16, "win_length": 64},
        "model": {"inter_channels": 32, "hidden_channels": 32,
                  "filter_channels": 64, "n_layers": 2,
                  "resblock_kernel_sizes": [3, 5],
                  "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]],
                  "upsample_rates": [4, 4], "upsample_initial_channel": 64,
                  "upsample_kernel_sizes": [8, 8], "gin_channels": 16},
        "num_phones": 24, "num_speakers": 3})
    model = random_init_(Synthesizer(cfg), 0).eval()
    x = torch.tensor([[3, 5, 7, 1, 2, 9, 11, 4], [6, 2, 8, 8, 1, 0, 0, 0]])
    xl, sid = torch.tensor([8, 5]), torch.tensor([0, 2])
    with torch.inference_mode():
        want, want_len, _ = model.infer(x, xl, sid, 0.0, 1.0, 0.0, 80)
        model.to(cuda)
        before = mrf_stage.launches
        got, got_len, _ = model.infer(x.to(cuda), xl.to(cuda),
                                      sid.to(cuda), 0.0, 1.0, 0.0, 80)
    assert mrf_stage.launches - before == 2 * 2 * 6
    assert torch.equal(got_len.cpu(), want_len)
    assert (got.cpu() - want).abs().max().item() <= 2e-4


def test_mrf_kernel_refuses_to_drop_a_gradient(cuda):
    """K1 has no backward: with autograd recording and an input or weight
    that requires grad it raises; under no_grad it runs."""
    gen = torch.Generator().manual_seed(1)
    stage = [[(w.to(cuda), b.to(cuda)) for w, b in br]
             for br in _stage(8, "2", gen)]
    h = torch.randn(1, 40, 8, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        mrf_stage(h.clone().requires_grad_(True), stage, "2", KERNEL_SIZES,
                  DILATIONS)
    stage[0][0][0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        mrf_stage(h, stage, "2", KERNEL_SIZES, DILATIONS)
    with torch.no_grad():
        mrf_stage(h, stage, "2", KERNEL_SIZES, DILATIONS)


def _mas_case(seed, b, t_spec, t_text, ragged):
    gen = torch.Generator().manual_seed(seed)
    neg_cent = torch.randn(b, t_spec, t_text, generator=gen) * 3
    if ragged:
        t_ys = torch.randint(t_text, t_spec + 1, (b,), generator=gen)
        t_xs = torch.minimum(
            torch.randint(1, t_text + 1, (b,), generator=gen), t_ys)
    else:
        t_ys, t_xs = torch.full((b,), t_spec), torch.full((b,), t_text)
    mask = ((torch.arange(t_spec)[None, :, None] < t_ys[:, None, None])
            & (torch.arange(t_text)[None, None, :] < t_xs[:, None, None]))
    return neg_cent, mask.float()


@pytest.mark.parametrize("b,t_spec,t_text,ragged", [
    (3, 40, 17, False), (6, 64, 23, True), (2, 9, 9, False),
    (2, 1, 1, False), (32, 400, 64, True), (32, 1000, 208, True),
    (2, 900, 700, True),  # three DP warps, bits in the scratch buffer
    (1, 20000, 40, True),  # decision bits in the scratch buffer
    (4, 700, 512, True),  # four DP warps of 128 columns
    (2, 1200, 1100, True),  # five DP warps of 256 columns
    (1, 1, 1, False), (3, 1, 5, False),
])
def test_mas_kernel_equals_plain(cuda, b, t_spec, t_text, ragged):
    """K2 against the plain version on the same inputs: exactly equal."""
    neg_cent, mask = _mas_case(t_spec, b, t_spec, t_text, ragged)
    neg_cent, mask = neg_cent.to(cuda), mask.to(cuda)
    before = maximum_path.launches
    got = maximum_path(neg_cent, mask)
    torch.cuda.synchronize()
    assert maximum_path.launches - before == 1
    assert not got.requires_grad
    assert torch.equal(got, maximum_path_reference(neg_cent, mask))


def _mas_holes(mask, seed):
    """Knock out a tenth of the cells inside each valid corner, row 0 and
    column 0 excepted (they set the lengths): there the -1e9 fill decides."""
    gen = torch.Generator().manual_seed(seed)
    holes = torch.rand(mask.shape, generator=gen) < 0.1
    holes[:, 0, :] = False
    holes[:, :, 0] = False
    return mask * ~holes


@pytest.mark.parametrize("kind", ["bool", "holes", "bool_holes",
                                  "non_contiguous", "bf16", "int_mask",
                                  "bool_odd", "bool_offset"])
def test_mas_kernel_takes_what_the_plain_version_takes(cuda, kind):
    """Masks as bool, with holes, scores non-contiguous or bf16, a mask of
    another type, a bool mask whose rows are not 4-byte aligned or that
    starts at an odd byte: one launch, exactly equal to the plain
    version."""
    shape = (5, 130, 37) if kind == "bool_odd" else (6, 300, 96)
    neg_cent, mask = _mas_case(11, *shape, True)
    if "holes" in kind:
        mask = _mas_holes(mask, 12)
    if "bool" in kind:
        mask = mask.bool()
    if kind == "int_mask":
        mask = mask.int()
    neg_cent, mask = neg_cent.to(cuda), mask.to(cuda)
    if kind == "bool_offset":
        storage = torch.zeros(mask.numel() + 1, dtype=torch.bool, device=cuda)
        mask = storage[1:].view(mask.shape).copy_(mask)
    if kind == "non_contiguous":
        neg_cent = neg_cent.transpose(1, 2).contiguous().transpose(1, 2)
        assert not neg_cent.is_contiguous()
    if kind == "bf16":
        neg_cent = neg_cent.bfloat16()
    before = maximum_path.launches
    got = maximum_path(neg_cent, mask)
    torch.cuda.synchronize()
    assert maximum_path.launches - before == 1
    assert torch.equal(got, maximum_path_reference(neg_cent, mask))


def test_mas_kernel_is_one_device_kernel(cuda):
    """f32 contiguous scores with an f32 or a bool mask: the call's only
    device work is K2 (no cast, no fill, no `* mask`, no memset)."""
    neg_cent, mask = _mas_case(13, 32, 400, 64, True)
    neg_cent, mask = neg_cent.to(cuda), mask.to(cuda)
    as_bool = mask.bool()
    assert kernels_per_call(lambda: maximum_path(neg_cent, mask)) == 1
    assert kernels_per_call(lambda: maximum_path(neg_cent, as_bool)) == 1


def test_mas_kernel_replays_in_a_cuda_graph(cuda):
    """No host synchronisation is left: the call is captured in a CUDA graph
    and replayed on new scores in the same buffers to the plain result."""
    neg_cent, mask = _mas_case(14, 8, 500, 128, True)
    neg_cent, mask = neg_cent.to(cuda), mask.to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        maximum_path(neg_cent, mask)  # warm-up: build, load, attributes
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = maximum_path(neg_cent, mask)
    for seed in (15, 16):
        fresh, _ = _mas_case(seed, 8, 500, 128, True)
        neg_cent.copy_(fresh.to(cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, maximum_path_reference(neg_cent, mask))


def test_mas_kernel_with_ties_and_an_empty_mask(cuda):
    """Integer scores make equal candidates common (the strict `<` decides);
    an all-zero mask clamps the lengths to 1."""
    neg_cent, mask = _mas_case(5, 8, 120, 50, True)
    neg_cent = torch.round(neg_cent / 3).to(cuda)
    mask = mask.to(cuda)
    mask[3] = 0
    got = maximum_path(neg_cent, mask)
    assert torch.equal(got, maximum_path_reference(neg_cent, mask))
    assert not got[3].any()


@pytest.mark.parametrize("seed,t_spec,t_text,ties", [
    (51, 100, 17, False), (52, 150, 100, False), (53, 90, 70, True),
    (54, 33, 33, True), (56, 200, 5, True), (57, 65, 65, False),
    (58, 64, 64, True), (59, 300, 260, True),
])
def test_mas_kernel_walk_edges(cuda, seed, t_spec, t_text, ties):
    """Shapes where the walk is easy to get wrong: ties, an index that
    crosses a 32-column word inside a 32-row round, and the diagonal
    (t_spec == t_text: the index steps on every row)."""
    neg_cent, mask = _mas_case(seed, 1, t_spec, t_text, False)
    if ties:
        neg_cent = torch.round(neg_cent / 3)
    neg_cent, mask = neg_cent.to(cuda), mask.to(cuda)
    got = maximum_path(neg_cent, mask)
    assert torch.equal(got, maximum_path_reference(neg_cent, mask))


def test_train_step_on_gpu_matches_cpu(cuda):
    """One training step on the GPU (K2 in the forward, the differentiable
    MRF route in the decoder) against the CPU, same seeded weights, draws
    fixed and dropout off: the alignment exactly equal, losses within rel
    1e-3 (checked inside the smoke script's phase, which raises), for
    VITS-base and the reduced VITS2 config."""
    from chip_smoke import REFERENCE_CONFIGS

    result = phase_train_reference()
    for name, (_, frames, _) in REFERENCE_CONFIGS.items():
        assert result[name]["max_rel_err_held"] <= 1e-3, name
        assert result[name]["attn_frames"] == sum(frames), name


# ---------------------------------------------------------------------------
# reduced precision: K1 in bf16, the int8 convolutions, K3
# ---------------------------------------------------------------------------

BF16_ULP = 2.0 ** -8  # spacing of bf16 relative to a value's power of two


def _close(got, want, ulps):
    """max |got - want| <= ulps * ulp(type) * max(1, max |want|)."""
    ulp = BF16_ULP if want.dtype == torch.bfloat16 else 2.0 ** -23
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ulps * ulp * scale, (err, ulps * ulp * scale)


@pytest.mark.parametrize("c,t", [(256, 768), (64, 12288), (32, 24576),
                                 (40, 1001), (256, 777), (16, 513), (8, 37)])
@pytest.mark.parametrize("kind", ["1", "2"])
def test_mrf_kernel_bf16_matches_plain(cuda, c, t, kind):
    """K1's bf16 instance (bf16 in, weights and out, f32 sums) against the
    plain version in bf16 (cuDNN, f32 sums, a rounding after every conv):
    the kernel rounds after bias and residual at once, the plain version
    after each, and a stage chains 3 residual convs per branch, so within 8
    bf16 ulps of max |plain|."""
    gen = torch.Generator().manual_seed(c)
    stage = [[(w.to(cuda, torch.bfloat16), b.to(cuda, torch.bfloat16))
              for w, b in br] for br in _stage(c, kind, gen)]
    h = torch.randn(2, t, c, generator=gen).to(cuda, torch.bfloat16)
    before = mrf_stage.launches
    got = mrf_stage(h, stage, kind, KERNEL_SIZES, DILATIONS)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert mrf_stage.launches - before == 9 * (2 if kind == "1" else 1)
    _close(got, mrf_stage_reference(h, stage, kind, KERNEL_SIZES, DILATIONS),
           8)


def test_mrf_kernel_refuses_mixed_types_and_a_gradient_in_bf16(cuda):
    gen = torch.Generator().manual_seed(2)
    stage32 = [[(w.to(cuda), b.to(cuda)) for w, b in br]
               for br in _stage(8, "2", gen)]
    h = torch.randn(1, 40, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # bf16 activations, f32 weights
        mrf_stage(h, stage32, "2", KERNEL_SIZES, DILATIONS)
    stage = [[(w.bfloat16(), b.bfloat16()) for w, b in br] for br in stage32]
    with pytest.raises(RuntimeError, match="no backward"):
        mrf_stage(h.clone().requires_grad_(True), stage, "2", KERNEL_SIZES,
                  DILATIONS)
    qstage = quantize_stage(stage32, torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        mrf_stage_int8(h.float().requires_grad_(True), qstage, "2", DILATIONS)
    with torch.no_grad():
        mrf_stage(h, stage, "2", KERNEL_SIZES, DILATIONS)


def _conv_tol(dtype, want):
    """One conv: f32 within 1e-4, bf16 within 2 roundings of the output
    type (the kernel rounds once, the plain version after the conv and
    after each sum), both times max(1, max |plain|)."""
    return ((1e-4 if dtype == torch.float32 else 2 * BF16_ULP)
            * max(1.0, want.float().abs().max().item()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", KERNEL_TAPS)
@pytest.mark.parametrize("c,t", [(256, 300), (32, 1001), (8, 23)])
def test_mrf_conv_taps_and_store_modes(cuda, dtype, k, c, t):
    """One launch at every tap count with dilation 5: the three store modes
    with and without a residual, and in place on the residual as ResBlock1
    runs its second conv."""
    gen = torch.Generator().manual_seed(c + k)
    w = (torch.randn(c, c, k, generator=gen) / (c * k) ** 0.5).to(cuda, dtype)
    bias = (torch.randn(c, generator=gen) * 0.1).to(cuda, dtype)
    x = torch.randn(2, t, c, generator=gen).to(cuda, dtype)
    res = torch.randn(2, t, c, generator=gen).to(cuda, dtype)
    before = mrf_stage.launches
    for r in (None, res):
        want = mrf_conv_reference(x, w, bias, 5, residual=r)
        tol = _conv_tol(dtype, want)
        got = mrf_conv(x, w, bias, 5, residual=r)
        assert (got.float() - want.float()).abs().max().item() <= tol
        scaled = mrf_conv(x, w, bias, 5, residual=r, mode=1, scale=1 / 3)
        assert (scaled.float() - want.float() / 3).abs().max().item() <= tol
        mrf_conv(x, w, bias, 5, residual=r, out=scaled, mode=2, scale=1 / 3)
        assert (scaled.float() - want.float() * (2 / 3)).abs().max().item() \
            <= 2 * tol
    want = mrf_conv_reference(x, w, bias, 5, residual=res)
    out = res.clone()
    assert mrf_conv(x, w, bias, 5, residual=out, out=out) is out
    torch.cuda.synchronize()
    assert (out.float() - want.float()).abs().max().item() \
        <= _conv_tol(dtype, want)
    assert mrf_stage.launches - before == 7
    with pytest.raises(ValueError):
        mrf_conv(x, w, bias, 5, out=x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrf_kernel_on_another_stream(cuda, dtype):
    """The kernel launches on PyTorch's current stream, whichever that is."""
    gen = torch.Generator().manual_seed(9)
    stage = [[(w.to(cuda, dtype), b.to(cuda, dtype)) for w, b in br]
             for br in _stage(64, "1", gen)]
    h = torch.randn(2, 3000, 64, generator=gen).to(cuda, dtype)
    want = mrf_stage_reference(h, stage, "1", KERNEL_SIZES, DILATIONS)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        got = mrf_stage(h, stage, "1", KERNEL_SIZES, DILATIONS)
    stream.synchronize()
    tol = (8 * BF16_ULP if dtype == torch.bfloat16 else 1e-4) * max(
        1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


def _rows(b, t, c, gen, dtype):
    """Activations with a loud row, a quiet row and a row of zeros (whose
    scale hits the 1e-12 floor)."""
    x = torch.randn(b, t, c, generator=gen)
    x[0] *= 100.0
    x[1] *= 0.01
    if b > 2:
        x[2] = 0.0
    return x.to("cuda", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_scale_equals_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(3)
    x = _rows(4, 1001, 32, gen, dtype)
    before = row_scale.launches
    for slope in (None, 0.1):
        assert torch.equal(row_scale(x, slope), row_scale_reference(x, slope))
    assert row_scale.launches - before == 2
    assert row_scale(x)[2].item() == pytest.approx(1e-12 / 127.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_scale_is_one_launch_that_resets_its_counter(cuda, dtype):
    """Q0's last block finishes the scales and zeroes the ticket counter:
    calls one after another (with 128 blocks a row and with one), and on a
    second stream, each equal the plain version."""
    gen = torch.Generator().manual_seed(4)
    big = _rows(5, 352, 512, gen, dtype)
    small = _rows(3, 7, 32, gen, dtype)
    for x in (big, small, big, big, small):
        assert torch.equal(row_scale(x, 0.1), row_scale_reference(x, 0.1))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [row_scale(big, 0.1) for _ in range(3)]
    torch.cuda.current_stream().wait_stream(side)
    for sx in got:
        assert torch.equal(sx, row_scale_reference(big, 0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out,k,d,t", [
    (32, 32, 3, 1, 1001), (32, 32, 11, 5, 777), (512, 512, 3, 5, 300),
    (64, 64, 7, 3, 129), (128, 256, 11, 1, 500), (96, 40, 5, 2, 260)])
def test_int8_conv_matches_plain(cuda, dtype, c_in, c_out, k, d, t):
    """The int32 sums are exact on both sides, so kernel and plain version
    differ only where they round f32 to the output type: within 1 ulp of
    the type at max |plain| (2 allowed)."""
    gen = torch.Generator().manual_seed(c_in + k)
    w = torch.randn(c_out, c_in, k, generator=gen) / (c_in * k) ** 0.5
    conv = QuantConv1d(w.to(cuda), (torch.randn(c_out, generator=gen)
                                    * 0.1).to(cuda), dtype)
    x = _rows(3, t, c_in, gen, dtype)
    before = int8_conv1d.launches, row_scale.launches
    got = int8_conv1d(x, conv, d, 0.1)
    torch.cuda.synchronize()
    assert (int8_conv1d.launches - before[0],
            row_scale.launches - before[1]) == (1, 1)
    want = int8_conv1d_reference(x, conv, d, 0.1)
    assert not got[2].float().abs().max().item() > \
        conv.bias.float().abs().max().item()  # the zero row: bias alone
    for row in range(3):  # each row at its own magnitude
        _close(got[row], want[row], 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_conv_store_modes(cuda, dtype):
    gen = torch.Generator().manual_seed(5)
    w = torch.randn(64, 64, 5, generator=gen) / 18.0
    conv = QuantConv1d(w.to(cuda), torch.zeros(64, device=cuda), dtype)
    x = _rows(2, 333, 64, gen, dtype)
    res = torch.randn(2, 333, 64, generator=gen).to(cuda, dtype)
    plain = int8_conv1d_reference(x, conv, 2, 0.1) + res
    out = res.clone()  # in place on the residual, as ResBlock1 runs it
    int8_conv1d(x, conv, 2, 0.1, residual=out, out=out)
    _close(out, plain, 2)
    acc = int8_conv1d(x, conv, 2, 0.1, residual=res, mode=1,
                      branch_scale=1 / 3)
    _close(acc, plain * (1 / 3), 2)
    int8_conv1d(x, conv, 2, 0.1, residual=res, out=acc, mode=2,
                branch_scale=1 / 3)
    _close(acc, plain * (1 / 3) + plain * (1 / 3), 3)
    with pytest.raises(ValueError):
        int8_conv1d(x, conv, 2, 0.1, out=x)


def _finish(amax):
    """`row_scale`'s last step on a gathered abs-max."""
    amax = torch.clamp_min(amax, 1e-12)
    return amax / torch.full_like(amax, 127.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("c", [256, 128, 64, 32])
def test_int8_conv_at_stage_widths(cuda, dtype, k, c):
    """Q1 at the four v1 stage widths, each kernel size and dilation, in
    every store mode, with a loud, a quiet and a zero batch row, the input
    scale given finished (`sx`) or as an abs-max (`x_amax`): each within 2
    ulps of the plain version per row (3 where two scaled values are
    summed), and the abs-max the epilogue takes of what it stores, once
    finished, equal to `row_scale` of the output."""
    gen = torch.Generator().manual_seed(c + k)
    w = torch.randn(c, c, k, generator=gen) / (c * k) ** 0.5
    conv = QuantConv1d(w.to(cuda), (torch.randn(c, generator=gen)
                                    * 0.1).to(cuda), dtype)
    x = _rows(3, 300, c, gen, dtype)
    res = torch.randn(3, 300, c, generator=gen).to(cuda, dtype)
    sx = row_scale(x, 0.1)
    x_amax = torch.nn.functional.leaky_relu(x, 0.1).abs().amax(
        dim=(1, 2)).float()
    for d in (1, 3, 5):
        want = int8_conv1d_reference(x, conv, d, 0.1)
        before = int8_conv1d.launches, row_scale.launches
        amax = torch.zeros(3, device=cuda)
        got = int8_conv1d(x, conv, d, 0.1, sx=sx, amax_out=amax)
        for row in range(3):
            _close(got[row], want[row], 2)
        assert torch.equal(_finish(amax), row_scale_reference(got, 0.1))
        out = res.clone()  # in place on the residual, as ResBlock1 runs it
        int8_conv1d(x, conv, d, 0.1, residual=out, out=out, x_amax=x_amax)
        plain = want + res
        for row in range(3):
            _close(out[row], plain[row], 2)
        acc = int8_conv1d(x, conv, d, 0.1, residual=res, mode=1,
                          branch_scale=1 / 3, sx=sx)
        amax.zero_()
        int8_conv1d(x, conv, d, 0.1, residual=res, out=acc, mode=2,
                    branch_scale=1 / 3, x_amax=x_amax, amax_out=amax)
        for row in range(3):
            _close(acc[row], plain[row] * (1 / 3) + plain[row] * (1 / 3), 3)
        assert torch.equal(_finish(amax), row_scale_reference(acc, 0.1))
        assert (int8_conv1d.launches - before[0],
                row_scale.launches - before[1]) == (4, 0)


def test_int8_packed_weights_renewed_after_load_state_dict(cuda):
    """The decoder's int8 copies, packed as Q1 streams them, are dropped on
    load_state_dict and packed anew from the new weights at next use."""
    cfg = Config.from_dict({
        "train": {"segment_size": 256},
        "data": {"filter_length": 64, "hop_length": 16, "win_length": 64},
        "model": {"inter_channels": 32, "hidden_channels": 32,
                  "filter_channels": 64, "n_layers": 2,
                  "resblock_kernel_sizes": [3], "resblock_dilation_sizes":
                  [[1, 3]], "upsample_rates": [4, 4],
                  "upsample_initial_channel": 128,
                  "upsample_kernel_sizes": [8, 8]},
        "num_phones": 24, "num_speakers": 1})
    dec = random_init_(Synthesizer(cfg), 0).dec.to(cuda).eval()
    kept = dec.form("int8").stages[0][0][0]
    dec.load_state_dict(random_init_(Synthesizer(cfg), 1).dec.state_dict())
    fresh = dec.form("int8").stages[0][0][0]
    assert fresh is not kept and fresh.packed.device.type == "cuda"
    assert not torch.equal(fresh.packed, kept.packed)
    assert torch.equal(fresh.packed, pack_int8_weight(fresh.wq))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_phase", [False, True])
@pytest.mark.parametrize("c_in,c_out,k,u,t", [
    (512, 256, 16, 8, 97), (64, 32, 4, 2, 1001), (128, 64, 4, 2, 130),
    (32, 16, 8, 8, 50), (64, 32, 7, 3, 77)])
def test_int8_conv_transpose_matches_plain(cuda, dtype, per_phase, c_in,
                                           c_out, k, u, t):
    gen = torch.Generator().manual_seed(c_in + u)
    w = torch.randn(c_in, c_out, k, generator=gen) / (c_in * k / u) ** 0.5
    conv = QuantConvTranspose1d(
        w.to(cuda), (torch.randn(c_out, generator=gen) * 0.1).to(cuda), u,
        (k - u) // 2, per_phase, dtype)
    x = _rows(3, t, c_in, gen, dtype)
    before = int8_conv_transpose1d.launches, row_scale.launches
    got = int8_conv_transpose1d(x, conv, 0.1)
    torch.cuda.synchronize()
    assert (int8_conv_transpose1d.launches - before[0],
            row_scale.launches - before[1]) == (1, 1)
    want = int8_conv_transpose1d_reference(x, conv, 0.1)
    assert got.shape == want.shape == (3, conv.out_length(t), c_out)
    for row in range(3):
        _close(got[row], want[row], 2)
    # given the abs-max of its input, as the decoder runs it: no row scale
    x_amax = torch.nn.functional.leaky_relu(x, 0.1).abs().amax(
        dim=(1, 2)).float()
    before = int8_conv_transpose1d.launches, row_scale.launches
    assert torch.equal(int8_conv_transpose1d(x, conv, 0.1, x_amax=x_amax),
                       got)
    assert (int8_conv_transpose1d.launches - before[0],
            row_scale.launches - before[1]) == (1, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out,k,u,t", [
    (512, 256, 16, 8, 352), (256, 128, 16, 8, 700), (128, 64, 4, 2, 1500),
    (64, 32, 4, 2, 3001), (256, 32, 8, 4, 99), (64, 32, 7, 3, 77)])
def test_int8_upsample_fused_abs_max(cuda, dtype, c_in, c_out, k, u, t):
    """Q2's epilogue takes max |lrelu(out)| per batch row over what it
    stores (a loud, a quiet and a zero row): finished, it equals
    `row_scale` of the output, the scale of the stage that reads it; the
    input scale given finished (`sx`) or as an abs-max (`x_amax`) gives the
    same output."""
    gen = torch.Generator().manual_seed(c_in + k + t)
    w = torch.randn(c_in, c_out, k, generator=gen) / (c_in * k / u) ** 0.5
    conv = QuantConvTranspose1d(
        w.to(cuda), (torch.randn(c_out, generator=gen) * 0.1).to(cuda), u,
        (k - u) // 2, True, dtype)
    x = _rows(3, t, c_in, gen, dtype)
    sx = row_scale(x, 0.1)
    x_amax = torch.nn.functional.leaky_relu(x, 0.1).abs().amax(
        dim=(1, 2)).float()
    amax = torch.zeros(3, device=cuda)
    got = int8_conv_transpose1d(x, conv, 0.1, sx=sx, amax_out=amax)
    torch.cuda.synchronize()
    assert torch.equal(_finish(amax), row_scale_reference(got, 0.1))
    assert torch.equal(int8_conv_transpose1d(x, conv, 0.1, x_amax=x_amax),
                       got)
    want = int8_conv_transpose1d_reference(x, conv, 0.1)
    for row in range(3):
        _close(got[row], want[row], 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,t,kind", [(256, 768, "1"), (32, 5000, "1"),
                                      (64, 1001, "2")])
def test_int8_stage_matches_plain(cuda, dtype, c, t, kind):
    """A whole int8 stage: 18 (9) conv launches and one scale launch for
    the stage's input; every other scale comes from an epilogue. A one-ulp
    difference in a conv's output can move a later conv's
    quantised input by one step, so the bound is a step of the 127-level
    grid, 1 / 127 of max |plain|, not an ulp."""
    gen = torch.Generator().manual_seed(c + 1)
    stage = quantize_stage([[(w.to(cuda), b.to(cuda)) for w, b in br]
                            for br in _stage(c, kind, gen)], dtype)
    h = torch.randn(2, t, c, generator=gen).to(cuda, dtype)
    before = int8_conv1d.launches, row_scale.launches
    got = mrf_stage_int8(h, stage, kind, DILATIONS)
    torch.cuda.synchronize()
    n = 9 * (2 if kind == "1" else 1)
    assert (int8_conv1d.launches - before[0],
            row_scale.launches - before[1]) == (n, 1)
    want = mrf_stage_int8_reference(h, stage, kind, DILATIONS)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= want.float().abs().max().item() / 127.0
    # as the decoder runs it: the input's abs-max from the upsample, the
    # output's from the last conv's epilogue, and no row scale
    x_amax = torch.nn.functional.leaky_relu(h, 0.1).abs().amax(
        dim=(1, 2)).float()
    amax = torch.zeros(2, device=cuda)
    before = int8_conv1d.launches, row_scale.launches
    fused = mrf_stage_int8(h, stage, kind, DILATIONS, x_amax=x_amax,
                           amax_out=amax)
    torch.cuda.synchronize()
    assert (int8_conv1d.launches - before[0],
            row_scale.launches - before[1]) == (n, 0)
    assert torch.equal(fused, got)
    assert torch.equal(_finish(amax), row_scale_reference(fused, 0.1))


@pytest.mark.parametrize("m,k,hops", [(8192, 1024, 16), (100, 256, 3),
                                      (65, 512, 1), (64, 1024, 0),
                                      (333, 384, 16)])
def test_int8_chain_equals_plain(cuda, m, k, hops):
    """Exactly equal, with M no multiple of the 256-row tile; one launch
    per hop."""
    gen = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 127, (m, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 127, (k, k), generator=gen, dtype=torch.int8)
    a, w = a.to(cuda), w.to(cuda)
    before = matmul_chain.launches
    got = matmul_chain(a, w, hops)
    torch.cuda.synchronize()
    assert matmul_chain.launches - before == hops
    assert torch.equal(got, matmul_chain_reference(a, w, hops))


@pytest.mark.parametrize("m,k,hops", [(8192, 1024, 16), (100, 128, 3),
                                      (33, 384, 1), (300, 640, 16)])
def test_bf16_chain_matches_plain(cuda, m, k, hops):
    """f32 sums in another order, rounded to bf16 after every hop: a sum
    near a rounding boundary lands one bf16 step apart and the next hops
    spread it, so within 2 ** -5 of max |plain| (4 bf16 steps there)."""
    gen = torch.Generator().manual_seed(k)
    a = torch.randn(m, k, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(k, k, generator=gen) * (32.0 / k ** 0.5)).to(
        cuda, torch.bfloat16)  # a hop keeps the magnitude at any K
    got = matmul_chain(a, w, hops)
    want = matmul_chain_reference(a, w, hops)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -5 * want.float().abs().max().item()


def test_chain_refuses_what_it_cannot_run(cuda):
    a = torch.zeros(8, 200, device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError):  # K % 256
        matmul_chain(a, torch.zeros(200, 200, device=cuda, dtype=torch.int8))
    with pytest.raises(ValueError):  # mixed types
        matmul_chain(torch.zeros(8, 256, device=cuda, dtype=torch.int8),
                     torch.zeros(256, 256, device=cuda,
                                 dtype=torch.bfloat16))


@pytest.mark.parametrize("precision,atol", [("bf16", 3e-2), ("int8", 3e-2)])
def test_reduced_infer_on_gpu_matches_cpu(cuda, precision, atol):
    """flow_reverse + decode at a reduced precision on the GPU (K1-bf16 or
    the int8 kernels) against the plain path on the CPU at the same
    precision: bf16 glue on both sides, rounded at other places by cuDNN
    and the CPU's convolutions, so within the JAX package's own drift bound
    for a reduced decoder (3e-2 on a tanh-bounded wave) and correlation
    above 0.99."""
    cfg = Config.from_dict({
        "train": {"segment_size": 256},
        "data": {"filter_length": 64, "hop_length": 16, "win_length": 64},
        "model": {"inter_channels": 32, "hidden_channels": 32,
                  "filter_channels": 64, "n_layers": 2,
                  "resblock_kernel_sizes": [3, 5],
                  "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]],
                  "upsample_rates": [4, 4], "upsample_initial_channel": 128,
                  "upsample_kernel_sizes": [8, 8], "gin_channels": 16},
        "num_phones": 24, "num_speakers": 3})
    model = random_init_(Synthesizer(cfg), 0).eval()
    gen = torch.Generator().manual_seed(4)
    z_p = torch.randn(2, 40, 32, generator=gen)
    mask = torch.ones(2, 40, 1)
    mask[1, 30:] = 0
    sid = torch.tensor([0, 2])

    def run(m, device):
        g = m._speaker(sid.to(device))
        z = m.flow_reverse(z_p.to(device), mask.to(device), g, precision)
        return m.decode(z, g, precision=precision).cpu()

    with torch.inference_mode():
        want = run(model, "cpu")
        model.to(cuda)
        counters = (mrf_stage, int8_conv1d, int8_conv_transpose1d,
                    row_scale)
        before = [f.launches for f in counters]
        got = run(model, cuda)
    moved = [f.launches - b for f, b in zip(counters, before)]
    # int8: one row scale per decode, of conv_pre's output
    assert moved == ([24, 0, 0, 0] if precision == "bf16"
                     else [0, 24, 2, 1])
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= atol
    assert torch.corrcoef(torch.stack([got.flatten(),
                                       want.flatten()]))[0, 1] > 0.99


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("c,t", [(256, 480), (128, 3840)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8"])
def test_kernels_at_chunk_shapes(cuda, b, c, t, dtype):
    """K1 (f32, bf16) and the int8 stage at the shapes the streamed decoder
    gives them: 60-frame chunks, decoded alone (B = 1) or 64 to a stack, at
    v1's first two stages (T = 480 and 3840 samples, no multiple of a
    128-row tile). Bounds as above: 1e-4 of max |plain| in f32, 8 bf16 ulps,
    1 / 127 of max |plain| for the int8 stage."""
    gen = torch.Generator().manual_seed(b + c)
    stage = [[(w.to(cuda), bias.to(cuda)) for w, bias in br]
             for br in _stage(c, "1", gen)]
    h = torch.randn(b, t, c, generator=gen).to(cuda)
    if dtype == "int8":
        q = quantize_stage(stage, torch.bfloat16)
        h = h.to(torch.bfloat16)
        before = int8_conv1d.launches
        got = mrf_stage_int8(h, q, "1", DILATIONS)
        torch.cuda.synchronize()
        assert int8_conv1d.launches - before == 18
        want = mrf_stage_int8_reference(h, q, "1", DILATIONS)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= want.float().abs().max().item() / 127.0
        return
    stage = [[(w.to(dtype), bias.to(dtype)) for w, bias in br]
             for br in stage]
    h = h.to(dtype)
    before = mrf_stage.launches
    got = mrf_stage(h, stage, "1", KERNEL_SIZES, DILATIONS)
    torch.cuda.synchronize()
    assert got.dtype == dtype and mrf_stage.launches - before == 18
    want = mrf_stage_reference(h, stage, "1", KERNEL_SIZES, DILATIONS)
    if dtype == torch.bfloat16:
        _close(got, want, 8)
    else:
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("precision,atol", [("f32", 2e-4), ("bf16", 3e-2),
                                            ("int8", 3e-2)])
def test_stream_batched_tail_equals_per_chunk_on_gpu(cuda, precision, atol):
    """stream_synthesize on the card at scales (0, 5, 0): the batched tail
    (one encode, the first chunk alone, the rest stacked) against one decode
    per chunk, chunk by chunk, at the decoder's precision; every chunk
    decode goes through K1 (f32, bf16) or the int8 kernels."""
    from wetts_tpu_torch.serving.engine import SynthesisEngine

    cfg = Config.from_dict({
        "train": {"segment_size": 256},
        "data": {"filter_length": 64, "hop_length": 16, "win_length": 64},
        "model": {"inter_channels": 32, "hidden_channels": 32,
                  "filter_channels": 64, "n_layers": 2,
                  "resblock_kernel_sizes": [3, 5],
                  "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]],
                  "upsample_rates": [4, 4], "upsample_initial_channel": 128,
                  "upsample_kernel_sizes": [8, 8], "gin_channels": 16},
        "num_phones": 24, "num_speakers": 3})
    phones = {"sil": 0, **{f"p{i}": i for i in range(1, 24)}}
    engine = SynthesisEngine(cfg, random_init_(Synthesizer(cfg), 0), phones,
                             {"a": 0, "b": 1, "c": 2}, noise_scale=0.0,
                             length_scale=5.0, noise_scale_w=0.0,
                             precision=precision)
    text = ". ".join(" ".join(f"p{(7 * k + j) % 23 + 1}" for j in range(30))
                     for k in range(9)) + "."
    counters = (mrf_stage, int8_conv1d)
    before = [f.launches for f in counters]
    batched = list(engine.stream_synthesize(text, "b"))
    moved = [f.launches - n for f, n in zip(counters, before)]
    assert (moved[0] > 0) == (precision != "int8")
    assert (moved[1] > 0) == (precision == "int8")
    engine.stream_batch_tail = False
    per_chunk = list(engine.stream_synthesize(text, "b"))
    assert len(batched) == len(per_chunk) > 9
    for got, want in zip(batched, per_chunk):
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() <= atol


@pytest.mark.parametrize("b", [1, 16, 64])
def test_istft_on_gpu_ignores_the_batch(cuda, b):
    """The Vocos decoder's iSTFT (n_fft 1024, hop 256) on 61 frames, B rows
    of one spectrum whose DC and Nyquist bins have an imaginary part: every
    row equal to the CPU's within 1e-5 * max|cpu| (cuFFT's inverse changed
    with the batch size before those parts were dropped)."""
    from wetts_tpu_torch.ops.spectral import istft

    gen = torch.Generator().manual_seed(b)
    re, im = (torch.randn(1, 61, 513, generator=gen) * 7 for _ in range(2))
    want = istft(re, im, 1024, 256, 1024)
    got = istft(re.cuda().expand(b, -1, -1), im.cuda().expand(b, -1, -1),
                1024, 256, 1024).cpu()
    assert got.shape == (b, 60 * 256)
    torch.testing.assert_close(got, want.expand(b, -1), rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_model_bundle_on_gpu_matches_cpu(cuda, tmp_path, precision):
    """`cli.model.Model` on a released-layout bundle (a numbered
    `G_<step>.pth`) on the card against the same bundle on the CPU, the
    normal draws made on the CPU for both: f32 within the int16 bound that
    2e-4 on the float wave implies after the peak scaling (2 * 2e-4 *
    19660.2 / peak + 1), int8 within the reduced decoders' 3e-2
    (correlation above 0.99); K1 or the int8 kernels launched."""
    import json

    from chip_smoke import cpu_drawn_noise
    from wetts_tpu_torch.cli.model import Model

    cfg_dict = {
        "train": {"segment_size": 256},
        "data": {"filter_length": 64, "hop_length": 16, "win_length": 64},
        "model": {"inter_channels": 32, "hidden_channels": 32,
                  "filter_channels": 64, "n_layers": 2,
                  "resblock_kernel_sizes": [3, 5],
                  "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]],
                  "upsample_rates": [4, 4], "upsample_initial_channel": 128,
                  "upsample_kernel_sizes": [8, 8], "gin_channels": 16}}
    cfg = Config.from_dict(dict(cfg_dict, num_phones=24, num_speakers=3))
    torch.save({"model": random_init_(Synthesizer(cfg), 0).state_dict()},
               tmp_path / "G_10.pth")
    (tmp_path / "config.json").write_text(json.dumps(cfg_dict))
    (tmp_path / "phones.txt").write_text(
        "".join(f"p{i} {i}\n" for i in range(1, 24)) + "sil 0\n")
    (tmp_path / "speaker.txt").write_text("spk0 0\nspk1 1\nspk2 2\n")
    text = "p1 p5 p9 p2 p7 p3 p11 p4 p8 p2"
    with cpu_drawn_noise(5):
        want_m = Model(str(tmp_path), precision=precision, device="cpu")
        wave_f = want_m.engine.synthesize(text, "spk1")
        want = want_m.synthesis(text, "spk1").astype(np.int32)
        counters = (mrf_stage, int8_conv1d)
        before = [f.launches for f in counters]
        got = Model(str(tmp_path), precision=precision).synthesis(
            text, "spk1").astype(np.int32)
    moved = [f.launches - b for f, b in zip(counters, before)]
    # 24 MRF convs a decode (2 stages of 2 branches of 3 conv pairs)
    assert moved == ([24, 0] if precision == "f32" else [0, 24])
    assert got.shape == want.shape and np.abs(want).max() > 1000
    peak = max(0.01, float(np.abs(wave_f).max()))
    atol = 2e-4 if precision == "f32" else 3e-2
    assert np.abs(got - want).max() <= 2 * atol * 0.6 * 32767 / peak + 1
    assert np.corrcoef(got, want)[0, 1] > 0.99


def test_bf16_wd_step_on_gpu(cuda):
    """One bf16 step of the reduced VITS2 reference config with the WavLM
    discriminator (a tiny random WavLM behind a resample) on the card: K2
    once on f32 scores, every metric finite, parameters and AdamW state
    f32, and `loss/disc` / `loss/mel` within 0.15 relative of the f32 step
    from the same weights (tests/test_train_bf16.py's bounds)."""
    import copy

    from chip_smoke import REFERENCE_CONFIGS
    from wetts_tpu_torch.models import synthesizer
    from wetts_tpu_torch.models.wavlm import (
        WavLMConfig,
        WavLMModel,
        make_slm_feature_fn,
    )
    from wetts_tpu_torch.train.state import GANTrainState
    from wetts_tpu_torch.train.step import build_models, train_step

    cfg_dict, frames, _ = REFERENCE_CONFIGS["vits2"]
    wcfg = WavLMConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    batch = {"phone_ids": torch.randint(1, 24, (2, 9), generator=gen),
             "text_lengths": torch.tensor([9, 7]),
             "wav": torch.randn(2, frames[0] * 16, generator=gen) * 0.3,
             "spec_lengths": torch.tensor(frames),
             "sid": torch.tensor([0, 1])}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    wavlm = random_init_(WavLMModel(wcfg), 1).to(cuda)
    fn = make_slm_feature_fn(wavlm, 8000, 16000)
    seen = []
    real = synthesizer.maximum_path

    def mas(neg_cent, mask):
        seen.append(neg_cent.dtype)
        return real(neg_cent, mask)

    metrics = {}
    synthesizer.maximum_path = mas
    try:
        for bf16 in (False, True):
            d = copy.deepcopy(cfg_dict)
            d["train"]["bf16_run"] = bf16
            d["model"].update(use_wd=True, slm_hidden=wcfg.hidden_size,
                              slm_nlayers=wcfg.num_layers + 1,
                              slm_initial_channel=8)
            cfg = Config.from_dict(d)
            nets = [random_init_(n, i).to(cuda)
                    for i, n in enumerate(build_models(cfg))]
            state = GANTrainState.create(cfg, *nets)
            before = maximum_path.launches
            metrics[bf16] = {k: float(v) for k, v in train_step(
                cfg, state, batch, torch.Generator(cuda).manual_seed(0),
                slm_feature_fn=fn).items()}
            assert maximum_path.launches - before == 1
    finally:
        synthesizer.maximum_path = real
    assert seen == [torch.float32, torch.float32]
    assert "loss/slm_disc" in metrics[True]
    assert all(np.isfinite(v) for v in metrics[True].values())
    for k in ("loss/disc", "loss/mel"):
        assert abs(metrics[True][k] - metrics[False][k]) < 0.15 * abs(
            metrics[False][k]), k
    for _, net, opt in state.nets():
        assert all(p.dtype == torch.float32 for p in net.parameters())
        assert all(v.dtype == torch.float32 for s in opt.state.values()
                   for v in s.values() if v.is_floating_point())


def test_media_decode_after_steps_matches_plain(cuda):
    """The eval media's decode after optimiser steps: `eval()` refolds the
    weight-norm buffers and drops K1's packed copies, so the decoder
    through K1 (72 launches for v1; here 2 stages x 2 branches x 6 convs)
    equals the differentiable decode from the live weight_g / weight_v
    within K1's f32 tolerance, 1e-4 * max(1, max|plain|)."""
    cfg = Config.from_dict({
        "train": {"segment_size": 256},
        "data": {"filter_length": 64, "hop_length": 16, "win_length": 64},
        "model": {"inter_channels": 32, "hidden_channels": 32,
                  "filter_channels": 64, "n_layers": 2,
                  "resblock_kernel_sizes": [3, 5],
                  "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]],
                  "upsample_rates": [4, 4], "upsample_initial_channel": 64,
                  "upsample_kernel_sizes": [8, 8], "gin_channels": 16},
        "num_phones": 24, "num_speakers": 3})
    model = random_init_(Synthesizer(cfg), 0).to(cuda).eval()
    z = torch.randn(2, 80, 32, device=cuda)
    sid = torch.tensor([0, 2], device=cuda)
    with torch.no_grad():
        model.decode(z, sid=sid)  # packs K1's weights
        model.train()
        for name, p in model.dec.named_parameters():  # an optimiser's move
            p.add_(1e-2 * torch.randn_like(p))
        want = model.decode(z, sid=sid)  # train(): the live weights
        model.eval()
        before = mrf_stage.launches
        got = model.decode(z, sid=sid)
    assert mrf_stage.launches - before == 2 * 2 * 6
    assert (got - want).abs().max().item() <= 1e-4 * max(
        1.0, want.abs().max().item())
