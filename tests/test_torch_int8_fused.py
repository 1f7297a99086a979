"""What the redesigned int8 kernels rely on and the CPU can check.

- Q1 (`csrc/int8_mrf_conv.cu`): its packed weight layout round-trips and
  follows the decoder's weights; its geometry fits every example config;
  the stage's scale plumbing (one `row_scale` of the stage input, every
  other conv's scale finished from the abs-max the conv before it took of
  what it stored) gives each conv the scale `row_scale_reference` gives its
  input and the stage `mrf_stage_int8_reference` exactly (the int8
  decoder, which runs the same plumbing on the CPU, is held against the
  JAX package's in tests/test_torch_quant.py).
- K3 (`csrc/int8_chain.cu`): the blocked layout of its operands, and the
  hop-by-hop ping-pong, emulated tile by tile in plain PyTorch.
- `utils/cuda_build.py`: an edited header builds anew.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from chip_smoke import random_init_
from wetts_tpu_torch.models import mrf, quant
from wetts_tpu_torch.models.hifigan import Generator
from wetts_tpu_torch.models.layers import LRELU_SLOPE
from wetts_tpu_torch.models.quant import (
    QuantConv1d,
    int8_conv1d,
    int8_conv_geometry,
    pack_int8_weight,
    row_scale,
    row_scale_reference,
    unpack_int8_weight,
)
from wetts_tpu_torch.ops.int8_chain import (
    BLOCK_BYTES,
    COL_TILE,
    ROW_TILE,
    matmul_chain_reference,
    pack_rows,
    unpack_rows,
)
from wetts_tpu_torch.utils import cuda_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "examples", "*", "configs",
                                        "*.json")))
KERNEL_SIZES, DILATIONS = (3, 7, 11), ((1, 3, 5),) * 3  # v1 resblocks


def _quant_stage(c, kind, seed, dtype):
    rng = np.random.default_rng(seed)
    n = 2 if kind == "1" else 1
    stage = [[(torch.from_numpy((rng.standard_normal((c, c, k))
                                 / np.sqrt(c * k)).astype(np.float32)),
               torch.from_numpy((0.1 * rng.standard_normal(c)).astype(
                   np.float32)))
              for _ in range(len(d) * n)]
             for k, d in zip(KERNEL_SIZES, DILATIONS)]
    return mrf.quantize_stage(stage, dtype)


def _rows(b, t, c, seed, dtype):
    """A loud, a quiet and a zero batch row."""
    x = np.random.default_rng(seed).standard_normal((b, t, c)).astype(
        np.float32)
    x[0] *= 100.0
    x[1] *= 0.01
    x[2] = 0.0
    return torch.from_numpy(x).to(dtype)


# ---- Q1: the packed weights ------------------------------------------------

@pytest.mark.parametrize("co,ci,k", [(32, 32, 3), (64, 128, 11), (40, 96, 5),
                                     (8, 20, 7), (256, 256, 1)])
def test_q1_pack_round_trips(co, ci, k):
    """[K][C_in / 16][C_out padded to the tile][16], zeros in the padding,
    and element (o, i, tap) at [tap][i // 16][o][i % 16]."""
    rng = np.random.default_rng(co + k)
    wq = torch.from_numpy(rng.integers(-127, 128, (co, ci, k),
                                       dtype=np.int8))
    p = pack_int8_weight(wq)
    nt = 16 if co <= 16 else 32 if co <= 32 else 64 if co <= 64 else 128
    assert p.dtype == torch.int8 and p.is_contiguous()
    assert p.shape == (k, -(-ci // 16), -(-co // nt) * nt, 16)
    assert torch.equal(unpack_int8_weight(p, co, ci), wq)
    assert int(p.abs().sum()) == int(wq.abs().sum())  # the padding is zero
    o, i, tap = co - 1, ci - 1, k // 2
    assert p[tap, i // 16, o, i % 16] == wq[o, i, tap]
    assert torch.equal(QuantConv1d(wq.float(), None).packed,
                       pack_int8_weight(QuantConv1d(wq.float(), None).wq))


def test_q1_packed_weights_follow_load_state_dict_and_eval():
    """The decoder's int8 copies (and with them Q1's packed weights) are
    dropped on load_state_dict and after train() -> eval(), as K1's packed
    stages are, and packed anew from the new weights."""
    def gen(seed):
        g = Generator(16, "1", (3,), ((1, 3),), (4, 4), 64, (8, 8),
                      gin_channels=0)
        return random_init_(g, seed).eval()

    dec = gen(0)
    kept = dec.form("int8").stages[0][0][0]
    assert dec.form("int8").stages[0][0][0] is kept  # derived once
    dec.load_state_dict(gen(1).state_dict())
    fresh = dec.form("int8").stages[0][0][0]
    assert fresh is not kept and not torch.equal(fresh.packed, kept.packed)
    assert torch.equal(fresh.packed, pack_int8_weight(fresh.wq))
    assert torch.equal(fresh.wq, quant.quantize_weight(
        dec.stage_convs(0)[0][0][0])[0])
    dec.train()
    dec.eval()
    assert dec.form("int8").stages[0][0][0] is not fresh


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_q1_geometry_fits_every_example_config(path, f32):
    """Every conv of every example config's int8 stages fits shared memory,
    in bf16 (the serving type) two blocks an SM (at most 115,712 bytes
    each), with C_in in whole 16-byte slices."""
    with open(path) as f:
        model = json.load(f)["model"]
    ch = model["upsample_initial_channel"]
    for i in range(len(model["upsample_rates"])):
        c = ch // 2 ** (i + 1)
        if c % 32:
            continue  # below the kernel's width; the CPU path runs it
        for k, dils in zip(model["resblock_kernel_sizes"],
                           model["resblock_dilation_sizes"]):
            for d in list(dils) + [1]:
                g = int8_conv_geometry(c, c, k, d, f32)
                limit = quant.SMEM_LIMIT if f32 else quant.TWO_BLOCKS
                assert g.smem_bytes <= limit, (c, k, d, g)
                assert g.rows_p % 8 == 1 and g.n_slices * 16 == c
                assert g.rows_p >= g.mt * 64 + (k - 1) * d
                assert g.co_p % g.nt == 0 and g.co_p >= c


def test_q1_geometry_refuses_what_the_kernel_cannot_take():
    for args in ((48, 32, 3, 1), (32, 12, 3, 1), (32, 32, 4, 1)):
        with pytest.raises(ValueError):
            int8_conv_geometry(*args, False)
    with pytest.raises(ValueError):  # a halo beyond shared memory
        int8_conv_geometry(256, 256, 11, 2000, False)


# ---- Q1: the producers' quantisation, emulated -----------------------------

def _round_bf16(x):
    """`round_bf16` of the kernel: f32 -> nearest bf16 by integer rounding."""
    u = x.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(
        np.uint32).view(np.float32)


def _quantize16(v, slope, sx, bf16):
    """`quantize16` of the kernel in numpy float32 (each step one IEEE f32
    operation, as on the card): the product with the reciprocal, the
    division only near a half-integer, rint and the integer through the
    adder."""
    f32, magic = np.float32, np.float32(12582912.0)
    n = v * f32(slope)
    if bf16:
        n = _round_bf16(n)
    l = np.where(v > 0, v, n).astype(f32)
    p = l * (f32(1) / f32(sx))
    r = (p + magic) - magic
    near = np.abs(np.abs(p - r) - f32(0.5)) <= f32(2 ** -20) * np.abs(p)
    p = np.where(near, l / f32(sx), p).astype(f32)
    c = np.clip(p, -127, 127).astype(f32)
    return (c + magic).view(np.int32) - 0x4B400000


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q1_quantisation_without_division_is_exact(dtype):
    """What the producers compute equals the plain version's
    clip(round(lrelu(x) / sx)) on random rows of every magnitude and on
    values at and one f32 step beside every half-integer multiple of sx;
    and the integer rounding to bf16 equals PyTorch's."""
    rng = np.random.default_rng(11)
    bf16 = dtype == torch.bfloat16
    for trial in range(8):
        x = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-3, 2)).astype(
            np.float32)
        x = torch.from_numpy(x).to(dtype)[None, :, None]
        sx = row_scale_reference(x, LRELU_SLOPE)
        half = (rng.integers(-127, 127, 500) + 0.5) * sx.double().item()
        half = half.astype(np.float32)
        edge = np.concatenate([half, np.nextafter(half, np.float32(np.inf)),
                               np.nextafter(half, np.float32(-np.inf))])
        xs = torch.cat([x.flatten(), torch.from_numpy(edge).to(dtype)])
        want = quant._quantize_rows(xs[None, :, None], LRELU_SLOPE, sx)
        got = _quantize16(xs.float().numpy(), LRELU_SLOPE, sx.item(), bf16)
        np.testing.assert_array_equal(got, want.flatten().int().numpy())
    v = rng.standard_normal(100000).astype(np.float32) * np.float32(1e-38)
    v = np.concatenate([v, rng.standard_normal(100000).astype(np.float32)])
    np.testing.assert_array_equal(
        _round_bf16(v), torch.from_numpy(v).bfloat16().float().numpy())


# ---- Q1: the fused scale on the CPU ----------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_gives_the_abs_max_of_what_it_stores(dtype):
    """`amax_out` takes max |lrelu(stored)| per row in every store mode;
    finished, it is `row_scale` of the stored tensor; a conv given that
    abs-max (`x_amax`) or the finished scale (`sx`) computes what it
    computes when it finds the scale itself."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy((rng.standard_normal((32, 32, 5)) / 12.0).astype(
        np.float32))
    conv = QuantConv1d(w, torch.zeros(32), dtype)
    x = _rows(3, 40, 32, 1, dtype)
    res = _rows(3, 40, 32, 2, dtype)
    amax = torch.zeros(3)
    y = int8_conv1d(x, conv, 3, LRELU_SLOPE, amax_out=amax)
    assert torch.equal(quant._scale_of(amax),
                       row_scale_reference(y, LRELU_SLOPE))
    assert amax[2] == 0.0  # a zero row stays zero: its scale is the floor
    for kwargs in ({"sx": row_scale(y, LRELU_SLOPE)}, {"x_amax": amax}):
        assert torch.equal(int8_conv1d(y, conv, 1, LRELU_SLOPE, **kwargs),
                           int8_conv1d(y, conv, 1, LRELU_SLOPE))
    out = torch.zeros_like(x)
    amax2 = torch.zeros(3)
    int8_conv1d(x, conv, 3, LRELU_SLOPE, residual=res, out=out,
                mode=quant.STORE_SCALED, branch_scale=0.5)
    int8_conv1d(x, conv, 3, LRELU_SLOPE, residual=res, out=out,
                mode=quant.ACCUMULATE_SCALED, branch_scale=0.5,
                amax_out=amax2)
    assert torch.equal(quant._scale_of(amax2),
                       row_scale_reference(out, LRELU_SLOPE))
    with pytest.raises(ValueError):
        int8_conv1d(y, conv, 1, LRELU_SLOPE, sx=amax, x_amax=amax)


@pytest.mark.parametrize("kind", ["1", "2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_scale_plumbing_equals_the_plain_stage(kind, dtype,
                                                     monkeypatch):
    """`mrf_stage_int8` on the CPU runs the CUDA path's plumbing through
    the plain versions: each conv's scale is `torch.equal` to
    `row_scale_reference` of its input, one `row_scale` serves the stage
    input, and the stage equals `mrf_stage_int8_reference`."""
    stage = _quant_stage(32, kind, 3, dtype)
    h = _rows(3, 64, 32, 4, dtype)
    seen, scales = [], []
    real_conv, real_scale = quant.int8_conv1d_reference, mrf.row_scale

    def conv_ref(x, conv, d, slope, sx=None):
        seen.append(torch.equal(sx, row_scale_reference(x, slope)))
        return real_conv(x, conv, d, slope, sx)

    def scale(x, slope=None):
        scales.append(x)
        return real_scale(x, slope)

    monkeypatch.setattr(quant, "int8_conv1d_reference", conv_ref)
    monkeypatch.setattr(mrf, "row_scale", scale)
    got = mrf.mrf_stage_int8(h, stage, kind, DILATIONS)
    monkeypatch.undo()
    assert len(seen) == 9 * (2 if kind == "1" else 1) and all(seen)
    assert len(scales) == 1 and scales[0] is h
    want = mrf.mrf_stage_int8_reference(h, stage, kind, DILATIONS)
    assert got.dtype == dtype and torch.equal(got, want)


# ---- K3: the blocked operands and the hop-by-hop chain ----------------------

@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("r,k,tile", [(300, 384, ROW_TILE), (7, 128, 256),
                                      (256, 256, COL_TILE)])
def test_k3_blocked_layout(dtype, r, k, tile):
    """[R / tile][K bytes / 128][8][tile][16]; element (r, c) at its byte
    offset; padded rows zero; the inverse gives the rows back."""
    gen = torch.Generator().manual_seed(r)
    x = (torch.randn(r, k, generator=gen) * 40).to(dtype)
    p = pack_rows(x, tile)
    es = x.element_size()
    assert p.shape == (-(-r // tile), k * es // BLOCK_BYTES, 8, tile, 16)
    assert torch.equal(unpack_rows(p, r, dtype), x)
    flat = p.reshape(-1)
    for row, col in ((0, 0), (r - 1, k - 1), (r // 2, k // 3)):
        byte = col * es
        at = ((((row // tile) * (k * es // BLOCK_BYTES) + byte // 128) * 8
               + byte % 128 // 16) * tile + row % tile) * 16 + byte % 16
        assert torch.equal(flat[at:at + es].view(dtype)[0], x[row, col])
    assert not unpack_rows(p, p.shape[0] * tile, dtype)[r:].float().any()


def _emulated_hop(src, wb, m_tile, n_tile, int8):
    """One block of the kernel: the 256 x 128 output tile (m_tile, n_tile)
    from the blocked a and w^T, K block by K block, requantised."""
    kb_a = src[m_tile].permute(2, 0, 1, 3).reshape(ROW_TILE, -1)
    kb_w = wb[n_tile].permute(2, 0, 1, 3).reshape(COL_TILE, -1)
    dtype = torch.int8 if int8 else torch.bfloat16
    a = kb_a.contiguous().view(dtype).double()
    w = kb_w.contiguous().view(dtype).double()
    y = a @ w.t()
    if int8:
        return torch.clamp(y.to(torch.int64) >> 10, -127, 127).to(torch.int8)
    return (y.float() * (1.0 / 32.0)).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_k3_hops_emulated_tile_by_tile_equal_the_chain(dtype):
    """The kernel's dataflow in plain PyTorch: per hop, every (row tile,
    column tile) block reads its K blocks from the packed operands and
    writes its requantised tile into the next hop's blocked buffer (the
    last hop row-major), ping-ponging as the C entry point does; equal to
    `matmul_chain_reference` (bf16: f32 sums in float64 here, so within
    2^-5 of max |plain| as on the card)."""
    gen = torch.Generator().manual_seed(5)
    m, k, hops = 300, 256, 3
    int8 = dtype == torch.int8
    if int8:
        a = torch.randint(-127, 127, (m, k), generator=gen, dtype=torch.int8)
        w = torch.randint(-127, 127, (k, k), generator=gen, dtype=torch.int8)
    else:
        a = torch.randn(m, k, generator=gen).to(dtype)
        w = (torch.randn(k, k, generator=gen) * (32.0 / k ** 0.5)).to(dtype)
    ping = [pack_rows(a, ROW_TILE), None]
    ping[1] = torch.empty_like(ping[0])
    wb = pack_rows(w.t(), COL_TILE)
    es = a.element_size()
    for h in range(hops):
        src, dst = ping[h % 2], ping[(h + 1) % 2]
        tiles = [[_emulated_hop(src, wb, mt, nt, int8)
                  for nt in range(k // COL_TILE)]
                 for mt in range(src.shape[0])]
        full = torch.cat([torch.cat(row, dim=1) for row in tiles])
        if h == hops - 1:
            got = full[:m]
        else:
            dst.copy_(pack_rows(full, ROW_TILE))
            # the tile of block (m_tile, n_tile) is the contiguous run at
            # K block n_tile * es of row tile m_tile, as the epilogue
            # writes it
            run = dst[1, 1 * es:2 * es].reshape(-1)
            want_run = pack_rows(tiles[1][1], ROW_TILE).reshape(-1)
            assert torch.equal(run, want_run)
    want = matmul_chain_reference(a, w, hops)
    if int8:
        assert torch.equal(got, want)
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2.0 ** -5 * want.float().abs().max().item()


# ---- the build: headers are part of a library's hash -----------------------

def test_editing_an_included_header_changes_the_library_path(tmp_path,
                                                             monkeypatch):
    """On a copy of csrc/: a source's path changes when a header it
    includes changes, and not when a header it does not include does."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    (csrc / "unused.cuh").write_text("// included by nothing\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    names = ("mrf_stage", "int8_chain", "int8_mrf_conv", "int8_conv", "mas")
    before = {n: cuda_build.library_path(n) for n in names}
    assert [p.name for p in cuda_build.sources("int8_chain")] == [
        "int8_chain.cu", "hopper.cuh"]
    (csrc / "unused.cuh").write_text("// still included by nothing\n")
    assert {n: cuda_build.library_path(n) for n in names} == before
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in names}
    for n in names:
        uses = "hopper.cuh" in [p.name for p in cuda_build.sources(n)]
        assert (after[n] != before[n]) == uses, n
    assert not (tmp_path / "_build").exists()  # nothing was built
