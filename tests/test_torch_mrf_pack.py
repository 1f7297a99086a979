"""What K1's CUDA kernel relies on and the CPU can check: the packed weight
layout, the split-TF32 arithmetic of the f32 instance, the geometry function
that sizes its tiles and shared memory, and the decoder's stages packed as
the kernel takes them (when they are packed anew is held with every other
derived value in tests/test_torch_derived.py).

The kernel itself runs only on the card (tests/test_torch_cuda.py); here its
layouts and sizes are held to what the source's note promises, and its f32
arithmetic is emulated in plain PyTorch.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import random_init_
from wetts_tpu_torch.models import hifigan
from wetts_tpu_torch.models.layers import LRELU_SLOPE
from wetts_tpu_torch.models.mrf import (
    ACCUMULATE_SCALED,
    SLICE_BYTES,
    SMEM_LIMIT,
    conv1d_split_tf32_reference,
    conv_geometry,
    mrf_conv,
    mrf_conv_reference,
    mrf_stage,
    mrf_stage_reference,
    pack_stage,
    pack_weight,
    round_tf32,
    split_tf32,
    unpack_weight,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "examples", "*", "configs",
                                        "*.json")))


def _weight(c, k, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((c, c, k)) / np.sqrt(c * k)
    return torch.from_numpy(w.astype(np.float32)).to(dtype)


# ---- (a) the packing -------------------------------------------------------

@pytest.mark.parametrize("c,k", [(8, 3), (16, 11), (32, 7), (40, 5),
                                 (64, 9), (256, 3)])
def test_pack_round_trips_bf16(c, k):
    w = _weight(c, k, c + k, torch.bfloat16)
    p = pack_weight(w)
    g = conv_geometry(c, k, 1, False)
    assert p.dtype == torch.bfloat16 and p.is_contiguous()
    assert tuple(p.shape) == (k, g.n_slices, g.co_p, 8)
    assert torch.equal(unpack_weight(p, c), w)
    # one (tap, slice) run: 16 bytes of C_in per output channel, in order
    assert torch.equal(p[k - 1, 0, :c, :min(c, 8)],
                       w[:, :min(c, 8), k - 1])
    # the padding of C_in to the instruction's depth and of C_out to the
    # tile holds zeros
    mask = torch.ones_like(p, dtype=torch.bool)
    flat = mask.permute(0, 1, 3, 2).reshape(k, g.n_slices * 8, g.co_p)
    flat[:, :c, :c] = False
    assert not p[flat.reshape(k, g.n_slices, 8, g.co_p)
                 .permute(0, 1, 3, 2)].any()


@pytest.mark.parametrize("c,k", [(8, 3), (16, 11), (36, 7), (64, 9),
                                 (256, 3)])
def test_pack_round_trips_f32_as_a_tf32_pair(c, k):
    w = _weight(c, k, c * k)
    p = pack_weight(w)
    g = conv_geometry(c, k, 1, True)
    assert tuple(p.shape) == (2, k, g.n_slices, g.co_p, 4)
    hi, lo = unpack_weight(p[0], c), unpack_weight(p[1], c)
    for part in (hi, lo):  # both parts are TF32 values: 13 low bits clear
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi, round_tf32(w))
    assert torch.equal(lo, round_tf32(w - hi))
    # hi + lo gives the weight back to 2^-21 of its magnitude
    assert ((hi.double() + lo.double() - w.double()).abs()
            <= 2.0 ** -21 * w.double().abs()).all()


def test_round_tf32_rounds_to_nearest_ties_away():
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    v = torch.tensor([1.0 + 0.49 * ulp, 1.0 + 0.5 * ulp, 1.0 + 0.51 * ulp,
                      -(1.0 + 0.5 * ulp), 0.0, 3.0])
    want = torch.tensor([1.0, 1.0 + ulp, 1.0 + ulp, -(1.0 + ulp), 0.0, 3.0])
    assert torch.equal(round_tf32(v), want)
    hi, lo = split_tf32(one * 1.2345678)
    assert hi + lo != hi and abs(float(hi + lo) - 1.2345678) < 2.0 ** -21


# ---- (b) why three TF32 products -------------------------------------------

def test_split_tf32_conv_keeps_f32_accuracy_and_one_pass_does_not():
    """The f32 instance's arithmetic, emulated (TF32 rounding by integer
    masking, three products, f32 sums), at v1's widest conv (C = 256, 11
    taps, dilation 5): within the port's f32 limit 1e-4 * max(1, max|plain|)
    of the plain version, by a factor of more than 20; a single TF32 pass
    breaks the limit. (The tensor cores' own f32 adders lose more than this
    emulation's exact f32 sums; that is measured on the card.)"""
    c, k, d, t = 256, 11, 5, 96
    rng = np.random.default_rng(0)
    w = _weight(c, k, 1)
    b = torch.from_numpy((rng.standard_normal(c) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, t, c)).astype(np.float32))
    want = mrf_stage_reference(x, [[(w, b)]], "2", (k,), ((d,),))
    limit = 1e-4 * max(1.0, want.abs().max().item())
    act = F.leaky_relu(x.transpose(1, 2), LRELU_SLOPE)

    def emulated(passes):
        y = conv1d_split_tf32_reference(act, w, d, passes)
        return (y + b[None, :, None] + x.transpose(1, 2)).transpose(1, 2)

    err3 = (emulated(3) - want).abs().max().item()
    err1 = (emulated(1) - want).abs().max().item()
    print(f"split TF32: {err3:.3g} ({err3 / limit:.2%} of the limit "
          f"{limit:.3g}); one pass: {err1:.3g} ({err1 / limit:.2f} x)")
    assert err3 <= limit / 20
    assert err1 > limit


# ---- (c) the geometry -------------------------------------------------------

def _convs_of(path):
    """(C, k, d) of every MRF conv of a config."""
    with open(path) as f:
        m = json.load(f)["model"]
    out = set()
    for i in range(len(m["upsample_rates"])):
        c = m["upsample_initial_channel"] // 2 ** (i + 1)
        for k, dils in zip(m["resblock_kernel_sizes"],
                           m["resblock_dilation_sizes"]):
            for d in dils:
                out.add((c, k, d))
                if m["resblock"] == "1":
                    out.add((c, k, 1))
    return sorted(out)


def test_example_configs_are_found():
    assert len(CONFIGS) >= 5
    convs = {conv for path in CONFIGS for conv in _convs_of(path)}
    assert {c for c, _, _ in convs} >= {8, 16, 32, 64, 128, 256}
    assert {k for _, k, _ in convs} >= {3, 5, 7, 11}


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: "-".join(p.split(os.sep)[-3::2]))
def test_geometry_fits_every_example_config(path, f32):
    for c, k, d in _convs_of(path):
        g = conv_geometry(c, k, d, f32)
        assert g.smem_bytes <= SMEM_LIMIT == 232448
        assert g.tt == g.wgs * g.mt * 64 and g.rows == g.tt + (k - 1) * d
        # the halo fits, and slices are stored where a row's 16-byte
        # stores of neighbouring slices fall into different banks
        assert g.rows_p >= g.rows and g.rows_p % 8 == 1
        # K padded to the instruction's depth (2 slices), N to the tile
        per_slice = SLICE_BYTES // (4 if f32 else 2)
        assert g.n_slices % 2 == 0 and g.n_slices * per_slice >= c
        assert g.co_p % g.nt == 0 and g.co_p >= c and g.nt % 8 == 0
        # every tap's shift of the operand's start is a whole 16-byte row
        for tap in range(k):
            shift = g.tap_shift_bytes(tap, d)
            assert shift % 16 == 0 and shift // 16 == tap * d
            assert tap * d + g.tt <= g.rows
        # rings and taps per weight tile are what the kernel can hold
        assert 1 <= g.x_stages <= 2 and 2 <= g.w_stages <= 4
        assert 1 <= g.tps <= k and g.parts == (2 if f32 else 1)
        assert len(g.for_kernel()) == 10
        if not f32 and d <= 5:  # two bf16 blocks share an SM
            assert 2 * (g.smem_bytes + 1024) <= 233472


def test_geometry_refuses_a_halo_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        conv_geometry(256, 11, 400, True)


# ---- (d) the decoder's stages as K1 takes them ----------------------------

def _generator(seed=0):
    """A small decoder with seeded random weights, folded, in eval mode."""
    gen = hifigan.Generator(16, "1", (3, 5), ((1, 3), (1, 3)), (2, 2), 32,
                            (4, 4), gin_channels=0)
    return random_init_(gen, seed).eval()


def test_pack_stage_keeps_the_branch_structure():
    gen = _generator()
    stage = gen.stage_convs(0)
    packed = pack_stage(stage)
    assert [len(convs) for convs in packed] == [len(c) for c in stage] == [4,
                                                                            4]
    assert all(pb is b or torch.equal(pb, b)
               for convs, pconvs in zip(stage, packed)
               for (_, b), (_, pb) in zip(convs, pconvs))


# ---- one launch by itself ---------------------------------------------------

def test_mrf_conv_on_the_cpu_is_the_plain_version_in_every_mode():
    """`mrf_conv` is one launch of the kernel on the card; on a CPU tensor
    it is its plain version, writes into `out` where one is given (in place
    on the residual too) and launches nothing. A one-conv ResBlock2 stage is
    the same function."""
    rng = np.random.default_rng(3)
    c, k, d = 16, 7, 3
    w = _weight(c, k, 5)
    b = torch.from_numpy((rng.standard_normal(c) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 50, c)).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal((2, 50, c)).astype(np.float32))
    before = mrf_stage.launches
    plain = mrf_conv_reference(x, w, b, d, residual=res)
    assert torch.equal(mrf_conv(x, w, b, d, residual=res), plain)
    assert torch.equal(mrf_conv(x, w, b, d, residual=x),
                       mrf_stage(x, [[(w, b)]], "2", (k,), ((d,),)))
    out = res.clone()
    assert mrf_conv(x, w, b, d, residual=out, out=out) is out
    assert torch.equal(out, plain)
    third = mrf_conv(x, w, b, d, residual=res, mode=1, scale=1 / 3)
    torch.testing.assert_close(third, plain / 3)
    mrf_conv(x, w, b, d, residual=res, out=third, mode=ACCUMULATE_SCALED,
             scale=1 / 3)
    torch.testing.assert_close(third, plain * (2 / 3))
    assert mrf_stage.launches == before
    with pytest.raises(ValueError):  # nothing to accumulate to
        mrf_conv(x, w, b, d, mode=ACCUMULATE_SCALED)
    with pytest.raises(ValueError):  # a residual of another shape
        mrf_conv(x, w, b, d, residual=res[:, :10])
    with pytest.raises(ValueError):  # weights of another width
        mrf_conv(x[..., :8], w, b, d)
