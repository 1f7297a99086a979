"""What Q2, the int8 upsample as one GEMM over phase x output channel
(`csrc/int8_mrf_conv.cu:int8_conv_transpose1d`), relies on and the CPU can
check, and the decoder's scale plumbing around it.

- The GEMM's weights (`QuantConvTranspose1d.gemm_weight`, packed in Q1's
  layout) round-trip, and the GEMM emulated in plain PyTorch (quantised
  shifted input rows times the packed `[n * C_in, u * C_out]` matrix,
  column `p * C_out + co` stored at output row `m * u - pd + p`) gives int32
  sums equal to the plain version's and outputs equal to it and to the JAX
  package's `_plain_tconv(q8=True)`, per channel and per phase.
- Its geometry fits every example config's upsamples, and its M positions
  cover every output row once.
- The scale contract on the CPU (`sx`, `x_amax`, `amax_out`), and the int8
  decoder's plumbing: one `row_scale` per decode, every other scale from an
  epilogue, each equal to `row_scale_reference` of the input it scales.

The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import random_init_
from wetts_tpu.models import hifigan_fast as jf
from wetts_tpu_torch.models import hifigan, mrf, quant
from wetts_tpu_torch.models.hifigan import Generator
from wetts_tpu_torch.models.layers import LRELU_SLOPE
from wetts_tpu_torch.models.quant import (
    QuantConvTranspose1d,
    int8_conv_transpose1d,
    int8_conv_transpose1d_reference,
    int8_upsample_geometry,
    row_scale,
    row_scale_reference,
    unpack_int8_weight,
    upsample_scale_per_phase,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "examples", "*", "configs",
                                        "*.json")))
# (C_in, C_out, k, u) at narrow widths: v1's two upsample shapes, v3's last
# one, and an odd kernel (pd = 2, n = 3, u * C_out no multiple of 128)
SHAPES = [(64, 32, 16, 8), (32, 16, 4, 2), (64, 32, 8, 4), (32, 32, 7, 3)]


def _rows(b, t, c, seed, dtype):
    """A loud, a quiet and a zero batch row."""
    x = np.random.default_rng(seed).standard_normal((b, t, c)).astype(
        np.float32)
    x[0] *= 100.0
    x[1] *= 0.01
    x[2] = 0.0
    return torch.from_numpy(x).to(dtype)


def _upsample(c_in, c_out, k, u, per_phase, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((c_in, c_out, k)) / np.sqrt(c_in * k / u))
    bias = 0.1 * rng.standard_normal(c_out)
    return QuantConvTranspose1d(torch.from_numpy(w.astype(np.float32)),
                                torch.from_numpy(bias.astype(np.float32)),
                                u, (k - u) // 2, per_phase, dtype)


def _gemm_sums(xq, conv):
    """The kernel's GEMM on quantised rows `xq [B, T_in, C_in]`: position m
    (M of them) times the packed weights, as exact int64 sums `[B, M, u *
    C_out]`. Tap i of position m is input row m - (n - 1) + i, zero outside
    [0, T_in)."""
    b, t_in, c_in = xq.shape
    n, u, pd = conv.taps_per_phase, conv.stride, conv.padding
    t_out = conv.out_length(t_in)
    m = (t_out - 1 + pd) // u + 1
    g = int8_upsample_geometry(c_in, conv.out_channels, conv.taps, u, False)
    assert conv.packed.shape == (n, c_in // 16, g.co_p, 16)
    w = unpack_int8_weight(conv.packed, u * conv.out_channels, c_in)
    padded = F.pad(xq.long(), (0, 0, n - 1, max(0, m - t_in)))
    a = torch.cat([padded[:, i:i + m] for i in range(n)], dim=2)
    return a @ w.long().permute(2, 1, 0).reshape(n * c_in, -1)


def _gemm_rows(y, conv, t_out):
    """Column p * C_out + co of position m to output row m * u - pd + p,
    clipped to [0, t_out): the flat run of the output from -pd * C_out."""
    b, m, _ = y.shape
    flat = y.reshape(b, m * conv.stride, conv.out_channels)
    return flat[:, conv.padding:conv.padding + t_out]


def _emulate(x, conv, slope, sx):
    """The kernel's arithmetic in plain PyTorch: quantise, the GEMM, the
    epilogue `rnd(f32(acc) * (sx * sw[col]))`, `rnd(v + bias)`, the rows."""
    xq = quant._quantize_rows(x, slope, sx)
    acc = _gemm_sums(xq, conv)
    sw = conv.packed_scale.reshape(-1)
    v = (acc.float() * (sx[:, None, None] * sw)).to(x.dtype)
    v = v + conv.packed_bias
    return _gemm_rows(v, conv, conv.out_length(x.shape[1]))


@pytest.mark.parametrize("c_in,c_out,k,u", SHAPES)
@pytest.mark.parametrize("per_phase", [False, True])
def test_gemm_weight_and_its_packing_round_trip(c_in, c_out, k, u,
                                                per_phase):
    """`gemm_weight()[p * O + co, ci, i]` is `wq[ci, co, p + u * (n - 1 -
    i)]` (zero past k); `packed` is it in Q1's layout, zero-padded, and
    unpacks to it; `packed_scale` is the scale of each column's phase."""
    conv = _upsample(c_in, c_out, k, u, per_phase, k + u)
    n = -(-k // u)
    gw = conv.gemm_weight()
    assert gw.shape == (u * c_out, c_in, n) and gw.dtype == torch.int8
    for p in range(u):
        for i in range(n):
            j = p + u * (n - 1 - i)
            want = conv.wq[:, :, j].t() if j < k else torch.zeros_like(
                conv.wq[:, :, 0].t())
            assert torch.equal(gw[p * c_out:(p + 1) * c_out, :, i], want)
    assert torch.equal(unpack_int8_weight(conv.packed, u * c_out, c_in), gw)
    assert int(conv.packed.abs().sum()) == int(conv.wq.abs().sum())
    assert conv.packed.is_contiguous()
    phases = (torch.arange(u) - (k - u) // 2) % u
    assert torch.equal(conv.packed_scale, conv.scale[phases])
    assert torch.equal(conv.packed_bias.view(u, c_out),
                       conv.bias.expand(u, c_out))


@pytest.mark.parametrize("c_in,c_out,k,u", SHAPES)
@pytest.mark.parametrize("per_phase", [False, True])
def test_gemm_emulation_equals_the_plain_version(c_in, c_out, k, u,
                                                 per_phase):
    """The GEMM's int32 sums equal the plain version's (a float64 transposed
    conv of the same integers), and its epilogue gives the plain version's
    output exactly, in f32 and bf16, with a loud, a quiet and a zero row."""
    for dtype in (torch.float32, torch.bfloat16):
        conv = _upsample(c_in, c_out, k, u, per_phase, c_in + k, dtype)
        x = _rows(3, 13, c_in, k, dtype)
        sx = row_scale_reference(x, LRELU_SLOPE)
        xq = quant._quantize_rows(x, LRELU_SLOPE, sx)
        want = F.conv_transpose1d(xq.double().transpose(1, 2),
                                  conv.wq.double(), stride=u,
                                  padding=conv.padding).transpose(1, 2)
        t_out = conv.out_length(13)
        got = _gemm_rows(_gemm_sums(xq, conv), conv, t_out)
        assert torch.equal(got.double(), want)
        assert torch.equal(
            _emulate(x, conv, LRELU_SLOPE, sx),
            int8_conv_transpose1d_reference(x, conv, LRELU_SLOPE))


@pytest.mark.parametrize("c_in,c_out,k,u", SHAPES)
def test_gemm_emulation_equals_jax(c_in, c_out, k, u):
    """Against the JAX package's `_plain_tconv(q8=True)` (per-channel
    scales, no leaky relu, no bias): the GEMM's sums dequantised as the
    kernel does give its output exactly."""
    rng = np.random.default_rng(c_in + u)
    w = (rng.standard_normal((c_in, c_out, k)) / np.sqrt(c_in * k / u))
    w = w.astype(np.float32)
    conv = QuantConvTranspose1d(torch.from_numpy(w), None, u, (k - u) // 2,
                                False)
    x = _rows(3, 11, c_in, u, torch.float32)
    p = {"kernel": jnp.asarray(w)}
    want = np.asarray(jf._plain_tconv(jnp.asarray(x.numpy()), p, u,
                                      conv.padding, q8=True))
    sx = row_scale_reference(x)
    acc = _gemm_sums(quant._quantize_rows(x, None, sx), conv)
    y = acc.float() * (sx[:, None, None] * conv.packed_scale.reshape(-1))
    got = _gemm_rows(y, conv, conv.out_length(11)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_upsample_geometry_fits_every_example_config(path, f32):
    """Every upsample of every example config that the kernel takes (C_in %
    32, C_out % 8) fits shared memory, in bf16 two blocks an SM; the input
    tile holds the n taps' halo and its ring every chunk of it; the columns
    cover u * C_out; and the M positions write every output row exactly
    once."""
    with open(path) as f:
        model = json.load(f)["model"]
    ch = model["upsample_initial_channel"]
    for i, (u, k) in enumerate(zip(model["upsample_rates"],
                                   model["upsample_kernel_sizes"])):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        if c_in % 32 or c_out % 8:
            with pytest.raises(ValueError):
                int8_upsample_geometry(c_in, c_out, k, u, f32)
            continue
        g = int8_upsample_geometry(c_in, c_out, k, u, f32)
        n = -(-k // u)
        limit = quant.SMEM_LIMIT if f32 else quant.TWO_BLOCKS
        assert g.smem_bytes <= limit, (c_in, c_out, k, u, g)
        assert g.rows_p % 8 == 1 and g.rows_p >= g.mt * 64 + n - 1
        assert g.n_slices * 16 == c_in
        assert g.co_p % g.nt == 0 and g.co_p >= u * c_out
        # the input ring holds a whole tile, so that a block can take
        # several N tiles of it with the input staged once
        assert g.x_stages >= -(-g.n_slices // quant.CHUNK_SLICES)
        pd = (k - u) // 2
        for t_in in (1, 7, 352):
            t_out = (t_in - 1) * u - 2 * pd + k
            m = (t_out - 1 + pd) // u + 1
            rows = np.arange(m)[:, None] * u + np.arange(u) - pd
            kept = rows[(rows >= 0) & (rows < t_out)]
            np.testing.assert_array_equal(np.sort(kept), np.arange(t_out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_scale_contract(dtype):
    """Given `x_amax` equals given `sx` equals finding the scale; `amax_out`
    takes max |lrelu(out)| per row, which finishes to `row_scale` of the
    output; a zero input row has the bias alone for output."""
    conv = _upsample(64, 32, 16, 8, True, 5, dtype)
    x = _rows(3, 9, 64, 6, dtype)
    plain = int8_conv_transpose1d(x, conv, LRELU_SLOPE)
    x_amax = F.leaky_relu(x, LRELU_SLOPE).abs().amax(dim=(1, 2)).float()
    amax = torch.zeros(3)
    for kwargs in ({"sx": row_scale(x, LRELU_SLOPE)}, {"x_amax": x_amax},
                   {"amax_out": amax}):
        assert torch.equal(int8_conv_transpose1d(x, conv, LRELU_SLOPE,
                                                 **kwargs), plain)
    assert torch.equal(quant._scale_of(amax),
                       row_scale_reference(plain, LRELU_SLOPE))
    assert torch.equal(plain[2], conv.bias.expand_as(plain[2]))
    with pytest.raises(ValueError):
        int8_conv_transpose1d(x, conv, LRELU_SLOPE, sx=x_amax, x_amax=x_amax)


@pytest.mark.parametrize("kind", ["1", "2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_scale_plumbing(kind, dtype, monkeypatch):
    """The int8 decoder on the CPU runs the CUDA path's plumbing through the
    plain versions: one `row_scale` per decode (conv_pre's output), every
    upsample and conv given the scale `row_scale_reference` gives its
    input, and the output equal to the plain chain (each upsample and stage
    finding its own scales)."""
    dec = random_init_(Generator(24, kind, (3, 5), ((1, 3),) * 2, (4, 2, 2),
                                 128, (8, 4, 4), gin_channels=0), 7).eval()
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 24, 10)).astype(np.float32))  # [B, C, T]
    x[1] *= 0.01
    seen, scales = [], []
    real = (quant.int8_conv1d_reference, quant.int8_conv_transpose1d_reference,
            quant.row_scale)

    def conv_ref(x, conv, d, slope, sx=None):
        seen.append(("conv", torch.equal(sx, row_scale_reference(x, slope))))
        return real[0](x, conv, d, slope, sx)

    def up_ref(x, conv, slope, sx=None):
        seen.append(("up", torch.equal(sx, row_scale_reference(x, slope))))
        return real[1](x, conv, slope, sx)

    def scale(x, slope=None):
        scales.append(x.shape)
        return real[2](x, slope)

    monkeypatch.setattr(quant, "int8_conv1d_reference", conv_ref)
    monkeypatch.setattr(quant, "int8_conv_transpose1d_reference", up_ref)
    monkeypatch.setattr(hifigan, "row_scale", scale)
    monkeypatch.setattr(mrf, "row_scale", scale)
    with torch.no_grad():
        got = dec._forward_reduced(x, None, "int8", dtype)
    monkeypatch.undo()
    n_convs = 3 * 2 * 2 * (2 if kind == "1" else 1)
    assert [s[0] for s in seen].count("up") == 3
    assert len(seen) == 3 + n_convs and all(ok for _, ok in seen)
    assert scales == [(3, 10, 128)]

    red = hifigan._Reduced(dec, "int8", dtype)
    per_phase = upsample_scale_per_phase(128, (4, 2, 2), 10)
    with torch.no_grad():
        h = F.conv1d(x.to(dtype), *red.conv_pre, padding=3).transpose(1, 2)
        for i, stage in enumerate(red.stages):
            h = int8_conv_transpose1d_reference(
                h, red.quantized_up(dec, i, per_phase[i]), LRELU_SLOPE)
            h = mrf.mrf_stage_int8_reference(h, stage, kind, dec.dilations)
        want = torch.tanh(F.conv1d(F.leaky_relu(h.transpose(1, 2), 0.01),
                                   *red.conv_post, padding=3)).float()
    assert got.shape == (3, 1, 10 * 16) and torch.equal(got, want)


def test_stage_takes_and_gives_the_scales_of_its_ends():
    """`mrf_stage_int8` given the abs-max of its input (`x_amax`) runs no
    `row_scale` and equals the stage that finds it; `amax_out` finishes to
    `row_scale` of the stage's output."""
    rng = np.random.default_rng(9)
    stage = mrf.quantize_stage(
        [[(torch.from_numpy((rng.standard_normal((32, 32, k)) / 10).astype(
            np.float32)), torch.zeros(32)) for _ in range(4)]
         for k in (3, 7)], torch.bfloat16)
    h = _rows(3, 40, 32, 10, torch.bfloat16)
    x_amax = F.leaky_relu(h, LRELU_SLOPE).abs().amax(dim=(1, 2)).float()
    before = row_scale.launches
    amax = torch.zeros(3)
    got = mrf.mrf_stage_int8(h, stage, "1", ((1, 3),) * 2, x_amax=x_amax,
                             amax_out=amax)
    assert row_scale.launches == before  # CPU: plain versions, no launch
    assert torch.equal(got, mrf.mrf_stage_int8(h, stage, "1", ((1, 3),) * 2))
    assert torch.equal(quant._scale_of(amax),
                       row_scale_reference(got, LRELU_SLOPE))
