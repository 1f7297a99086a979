#!/usr/bin/env python3
"""Drive the PyTorch port (`wetts_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
1. print the card's name and power limit; build every CUDA kernel of the
   port from `wetts_tpu_torch/csrc/` (one nvcc per source, all at once);
2. hold kernel K1 (`mrf_stage`), in f32 (TF32 off) and in bf16, against its
   plain PyTorch version at the four VITS-base MRF stage shapes of a batch
   of 4 at the 352-frame decode bucket, and time both, and beside them the
   library's convolutions of each stage alone; time the model's three
   synthesis stages at the same bucket;
3. hold the int8 kernels (row scale Q0, dilated conv Q1 and transposed
   conv Q2, both taking the abs-max of their output in their epilogue, a
   whole int8 MRF stage) against their plain versions at the same shapes
   in bf16: the integer sums are exact on both sides, so a single launch
   agrees to the rounding of the output type and a fused scale is equal;
   Q0 at conv_pre's output (the one row scale left per decode); each
   upsample with its scale work as the decoder runs it and alone; per
   stage, the whole stage as the decoder runs it and K1-bf16's time for
   the same stage;
4. hold K3 (`matmul_chain`, 16 dependent [8192, 1024] x [1024, 1024]
   products, one launch per hop) against its plain version, int8 exactly
   and bf16 within a stated bound, and run the probe that times both
   chains, beside the same hops through `torch._int_mm` / `torch.matmul`
   (timed here only), with the bytes of `w` each chain reads from L2;
5. the serving main path, once per precision (f32, bf16 = `half`, int8 =
   `quantize`): batches of 4 raw-phone requests of about 4 s of audio each
   through `SynthesisEngine` on the GPU at the full width of
   examples/baker/configs/v1.json (seeded random weights, a synthetic phone
   table, 4 speakers), all the audio over all the wall time; then 3 HTTP
   requests through `TtsServer` on 127.0.0.1 (on the f32 and on the int8
   engine). The reduced engines must give the f32 engine's lengths and its
   audio within the JAX package's own drift bounds;
6. check each precision's GPU audio against the plain path on the CPU on a
   small input;
7. hold kernel K2 (`maximum_path`, monotonic alignment search) exactly equal
   to its plain PyTorch version at the shapes v1 training produces, and time
   both;
8. train: write a seeded synthetic corpus (64 noise-like utterances of
   3.5-11 s, 4 speakers) to a temporary directory, build `Trainer` from
   v1.json as it stands (batch 32, segment 8192, f32) with seeded random
   weights, take 1 warm-up and 4 timed steps, save, resume in a second
   `Trainer` and take one more; check metrics, moved parameters and the
   first step's alignment, and split one step's device time by phase;
9. check one training step on the GPU against the CPU at a small size.
Phase 5 is the serving main path, phase 8 the training main path and the
probe of phase 4 K3's own: each kernel's launch count is zeroed just before
its path and read just after (under `half` every MRF stage goes through
K1's bf16 instance and no int8 kernel runs; under `quantize` it is the
reverse; K1 must not move while training, K2 launches once per step). The
last two lines are the kernels JSON and the device JSON. Imports nothing of
JAX; needs a CUDA device.
"""

from __future__ import annotations

import base64
import concurrent.futures
import contextlib
import copy
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.parse
import urllib.request
import wave

import numpy as np
import torch

from wetts_tpu_torch.utils.profiling import cuda_ms, device_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "examples", "baker", "configs", "v1.json")
KERNELS = ("mrf_stage", "mas", "int8_conv", "int8_mrf_conv", "int8_chain")
# H100 SXM published peaks at the 700 W limit (NVIDIA data sheet), dense
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
BATCH, FRAME_BUCKET = 4, 352
N_PHONES, N_SPEAKERS, SEED = 64, 4, 1234
# batches of BATCH ~4 s requests per precision: a window of a second or so
SYNTH_BATCHES = {"f32": 8, "bf16": 16, "int8": 16}
BF16_ULP = 2.0 ** -8
# K2 at the [B, T_spec, T_text] shapes v1 training produces (batch 32, frame
# buckets up to 1000, text padded to a multiple of 16), a 1x1 and a square
MAS_SHAPES = ((32, 400, 64), (32, 700, 128), (32, 1000, 208), (2, 1, 1),
              (4, 48, 48))
TRAIN_UTTERANCES, TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS = 64, 1, 4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def one_tile_ms(stage_fn, h: torch.Tensor) -> float:
    """A stage's time on 128 samples of one row, a single tile per launch:
    the launches, the gaps between them and one block's latency from start
    to end, with no parallel work to hide them. Divided by the launches it
    bounds the gap between two launches from above."""
    tiny = h[:1, :128].contiguous()
    return cuda_ms(lambda: stage_fn(tiny), 20)


def stage_cost(b: int, t: int, c: int, kernel_sizes, dilations, kind,
               act_bytes: int = 4, weight_bytes: int = 4):
    """(operations, bytes) one MRF stage must do and move: 2*C*C*k per conv
    tap per sample; input and output read and written once, weights once."""
    from wetts_tpu_torch.models.mrf import convs_per_branch

    taps = sum(k * convs_per_branch(kind, d)
               for k, d in zip(kernel_sizes, dilations))
    n_convs = sum(convs_per_branch(kind, d) for d in dilations)
    flops = 2 * c * c * taps * b * t
    nbytes = (act_bytes * 2 * b * t * c + weight_bytes * c * c * taps
              + act_bytes * c * n_convs)
    return flops, nbytes


def conv_dilations(kind: str, dils) -> list:
    """The dilation of each conv of a resblock branch, in execution order."""
    return [d for dil in dils for d in ((dil, 1) if kind == "1" else (dil,))]


def stage_shapes(gen_cfg):
    """(stage, T, C) of the four MRF stages at the decode bucket."""
    t = FRAME_BUCKET
    for i, u in enumerate(gen_cfg.upsample_rates):
        t *= u
        yield i, t, gen_cfg.upsample_initial_channel // 2 ** (i + 1)


@torch.no_grad()
def phase_kernels(model, gen_cfg, dtype=torch.float32):
    """K1 against its plain version at the v1 stage shapes, in f32 or in
    bf16 (inference: K1 has no backward and refuses inputs that record a
    gradient), timed in turns with the plain chain and with the library's
    convolutions of the stage alone (one F.conv1d per conv and nothing
    else; in f32 with cuDNN's TF32 off and on), which the port never calls.
    The f32 instance does three TF32 tensor-core products per f32 product,
    so that is its bound; the f32 CUDA-core bound stands beside it."""
    import torch.nn.functional as F

    from wetts_tpu_torch.models.mrf import (
        mrf_stage,
        mrf_stage_reference,
        pack_stage,
    )

    kind = gen_cfg.resblock
    ks = tuple(gen_cfg.resblock_kernel_sizes)
    ds = tuple(tuple(d) for d in gen_cfg.resblock_dilation_sizes)
    bf16 = dtype == torch.bfloat16
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for i, t, c in stage_shapes(gen_cfg):
        stage = (model.dec.reduced("bf16").stages[i] if bf16
                 else model.dec.stage_convs(i))
        packed = pack_stage(stage)  # as the decoder keeps it
        h = torch.randn(BATCH, t, c, device="cuda", generator=gen).to(dtype)
        got = mrf_stage(h, stage, kind, ks, ds, packed=packed)
        want = mrf_stage_reference(h, stage, kind, ks, ds)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        check(bool(torch.isfinite(got).all()) and got.dtype == dtype,
              f"stage {i}: non-finite or of another type")
        # f32: sums of up to C*k = 2816 products taken in another order, in
        # the tensor cores' f32 adders, of operands split into TF32 parts.
        # bf16: f32 sums on both sides, but the kernel rounds once after
        # bias and residual where the plain chain rounds after each, over 3
        # residual convs per branch: within 8 bf16 ulps of max |plain|
        tol = (8 * BF16_ULP if bf16 else 1e-4) * scale
        check(err <= tol, f"stage {i} {dtype}: max |kernel - plain| {err} > "
                          f"{tol}")
        ht = h.transpose(1, 2).contiguous()
        convs = [(w, k, d) for branch, k, dils in zip(stage, ks, ds)
                 for (w, _), d in zip(branch, conv_dilations(kind, dils))]

        def kernel():
            mrf_stage(h, stage, kind, ks, ds, packed=packed)

        def plain():
            mrf_stage_reference(h, stage, kind, ks, ds)

        def library():
            for w, k, d in convs:
                F.conv1d(ht, w, padding=(k - 1) * d // 2, dilation=d)

        # in turns: kernel, plain, library, kernel
        ms = cuda_ms(kernel, 10)
        plain_ms = cuda_ms(plain, 3)
        library_ms = cuda_ms(library, 3)
        ms = 0.5 * (ms + cuda_ms(kernel, 10))
        nb = 2 if bf16 else 4
        flops, nbytes = stage_cost(BATCH, t, c, ks, ds, kind, nb, nb)
        # bf16: one tensor-core product per product; f32: three TF32 ones
        ops_ms = 1e3 * (flops / PEAK_BF16_FLOPS if bf16
                        else 3 * flops / PEAK_TF32_FLOPS)
        row = {"stage": i, "B": BATCH, "T": t, "C": c, "max_abs_err": err,
               "max_abs_plain": scale, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "bound_ms": max(ops_ms, 1e3 * nbytes / PEAK_BYTES),
               "gflop": flops / 1e9, "tflops": flops / ms / 1e9,
               "one_tile_ms": one_tile_ms(
                   lambda x: mrf_stage(x, stage, kind, ks, ds,
                                       packed=packed), h)}
        if not bf16:
            row["bound_f32_cuda_core_ms"] = 1e3 * flops / PEAK_F32_FLOPS
            torch.backends.cudnn.allow_tf32 = True
            try:
                row["library_tf32_ms"] = cuda_ms(library, 3)
            finally:
                torch.backends.cudnn.allow_tf32 = False
        print(("K1-bf16 stage " if bf16 else "K1 stage ") + json.dumps(row))
        rows.append(row)
    return rows


def _ulps(got, want) -> float:
    """max |got - want| in units of the output type's spacing at
    max(1, max |want|), per batch row (rows have their own scales)."""
    ulp = BF16_ULP if want.dtype == torch.bfloat16 else 2.0 ** -23
    worst = 0.0
    for g, w in zip(got.float(), want.float()):
        scale = max(1.0, w.abs().max().item())
        worst = max(worst, (g - w).abs().max().item() / (ulp * scale))
    return worst


@torch.no_grad()
def phase_int8_kernels(model, gen_cfg, k1_bf16_rows):
    """The int8 kernels against their plain versions at the v1 shapes, in
    bf16 as the serving path runs them. The integer sums are exact on both
    sides (the plain version takes them in float64), so one conv agrees to
    the rounding of bf16: at most 2 ulps of the row's max |plain| are
    allowed, 1 is expected; the abs-max a conv or an upsample takes of its
    output, once finished, must equal `row_scale` of that output. Over a
    whole stage a one-ulp difference can move a later conv's quantised input
    by one of its 127 steps, so the stage is held to 1 / 127 of max |plain|.
    Scales as the decoder takes them: Q0 once, at conv_pre's output; each
    upsample's `ms` with its scale work (the first one's Q0 launch, the
    others' abs-max finished in the kernel, and its own abs-max epilogue),
    `conv_ms` given a finished scale; each stage given its input's abs-max,
    taking its output's, beside K1-bf16's time for the same stage in this
    run (`k1_bf16_rows`). `ms` is back to back, as every kernel here is
    timed, so a call whose host work outlasts its device work is timed by
    the host; `device_ms` (Q0, Q2 and Q2's library call) is the device's
    alone, the launches queued behind a sleep."""
    from wetts_tpu_torch.models.mrf import (
        mrf_stage_int8,
        mrf_stage_int8_reference,
    )
    from wetts_tpu_torch.models.layers import LRELU_SLOPE
    from wetts_tpu_torch.models.quant import (
        int8_conv1d,
        int8_conv1d_reference,
        int8_conv_transpose1d,
        int8_conv_transpose1d_reference,
        row_scale,
        row_scale_reference,
        upsample_scale_per_phase,
    )
    import torch.nn.functional as F

    kind = gen_cfg.resblock
    ks = tuple(gen_cfg.resblock_kernel_sizes)
    ds = tuple(tuple(d) for d in gen_cfg.resblock_dilation_sizes)
    red = model.dec.reduced("int8")
    per_phase = upsample_scale_per_phase(
        gen_cfg.upsample_initial_channel, gen_cfg.upsample_rates,
        FRAME_BUCKET)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def finish(amax):
        return torch.clamp_min(amax, 1e-12) / torch.full_like(amax, 127.0)

    def abs_max(x):
        return F.leaky_relu(x, LRELU_SLOPE).abs().amax(dim=(1, 2)).float()

    def loud_and_quiet(*shape):
        x = torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)
        x[1] *= 0.01  # a quiet row beside the loud ones
        return x

    out = {"stage": [], "conv": [], "up": [], "scale": []}
    # ---- Q0: the one row scale left per decode, of conv_pre's output
    x0 = loud_and_quiet(BATCH, FRAME_BUCKET, gen_cfg.upsample_initial_channel)
    check(torch.equal(row_scale(x0, LRELU_SLOPE),
                      row_scale_reference(x0, LRELU_SLOPE)),
          "the row scale differs from the plain version")
    row = {"T": FRAME_BUCKET, "C": x0.shape[2], "max_abs_err": 0.0,
           "ms": cuda_ms(lambda: row_scale(x0, LRELU_SLOPE), 20),
           "device_ms": device_ms(lambda: row_scale(x0, LRELU_SLOPE)),
           "plain_ms": cuda_ms(lambda: row_scale_reference(
               x0, LRELU_SLOPE), 5),
           "bound_ms": 1e3 * 2 * x0.numel() / PEAK_BYTES}
    print("Q0 row scale " + json.dumps(row))
    out["scale"].append(row)

    t_in = FRAME_BUCKET
    for i, t, c in stage_shapes(gen_cfg):
        # ---- the upsample into this stage: [B, t_in, 2C] -> [B, t, C]
        up = red.quantized_up(model.dec, i, per_phase[i])
        x = x0 if i == 0 else loud_and_quiet(BATCH, t_in, 2 * c)
        x_amax, sx = abs_max(x), row_scale(x, LRELU_SLOPE)
        amax = torch.zeros(BATCH, device="cuda")
        got = int8_conv_transpose1d(x, up, LRELU_SLOPE, x_amax=x_amax,
                                    amax_out=amax)
        want = int8_conv_transpose1d_reference(x, up, LRELU_SLOPE)
        ulps = _ulps(got, want)
        check(got.shape == (BATCH, t, c) and ulps <= 2.0,
              f"int8 upsample {i}: {ulps} ulps from the plain version")
        check(torch.equal(finish(amax), row_scale_reference(got, LRELU_SLOPE)),
              f"the fused abs-max of upsample {i} differs from row_scale's")
        check(torch.equal(int8_conv_transpose1d(x, up, LRELU_SLOPE, sx=sx),
                          got), f"upsample {i} given sx differs")
        w_f = model.dec.ups[i].weight.to(torch.bfloat16)
        xt = x.transpose(1, 2).contiguous()
        ops = 2 * BATCH * t_in * 2 * c * c * up.taps
        nbytes = 2 * BATCH * (t_in * 2 * c + t * c) + up.wq.numel()

        def with_scale_work():
            # as the decoder runs it: the first upsample after the one row
            # scale, the others finishing the abs-max the stage before took
            if i == 0:
                int8_conv_transpose1d(x, up, LRELU_SLOPE,
                                      sx=row_scale(x, LRELU_SLOPE),
                                      amax_out=amax)
            else:
                int8_conv_transpose1d(x, up, LRELU_SLOPE, x_amax=x_amax,
                                      amax_out=amax)

        def library():
            F.conv_transpose1d(xt, w_f, stride=up.stride, padding=up.padding)

        # in turns: with scale work, conv alone, library, with scale work
        ms = cuda_ms(with_scale_work, 20)
        conv_ms = cuda_ms(lambda: int8_conv_transpose1d(
            x, up, LRELU_SLOPE, sx=sx), 20)
        library_ms = cuda_ms(library, 20)
        ms = 0.5 * (ms + cuda_ms(with_scale_work, 20))
        row = {"stage": i, "T_in": t_in, "C_in": 2 * c, "C_out": c,
               "k": up.taps, "u": up.stride, "per_phase": per_phase[i],
               "ulps": ulps,
               "max_abs_err": (got.float() - want.float()).abs().max().item(),
               "ms": ms, "conv_ms": conv_ms,
               "device_ms": device_ms(with_scale_work),
               "library_device_ms": device_ms(library),
               "plain_ms": cuda_ms(lambda: int8_conv_transpose1d_reference(
                   x, up, LRELU_SLOPE), 1),
               "library_ms": library_ms,
               "bound_ms": 1e3 * max(ops / PEAK_INT8_OPS,
                                     nbytes / PEAK_BYTES),
               "bound_by": ("bytes" if nbytes / PEAK_BYTES
                            >= ops / PEAK_INT8_OPS else "operations"),
               "gop": ops / 1e9, "mb": nbytes / 1e6}
        print("Q2 upsample " + json.dumps(row))
        out["up"].append(row)
        t_in = t

        # ---- the widest conv (k = 11, dilation 5)
        h = loud_and_quiet(BATCH, t, c)
        conv = red.stages[i][-1][4]  # conv1 of dilation 5, 11 taps
        sx = row_scale(h, LRELU_SLOPE)
        amax = torch.zeros(BATCH, device="cuda")
        got = int8_conv1d(h, conv, 5, LRELU_SLOPE, sx=sx, amax_out=amax)
        want = int8_conv1d_reference(h, conv, 5, LRELU_SLOPE)
        ulps = _ulps(got, want)
        check(ulps <= 2.0, f"int8 conv at stage {i}: {ulps} ulps from the "
                           f"plain version")
        check(torch.equal(finish(amax), row_scale_reference(got, LRELU_SLOPE)),
              f"the fused abs-max at stage {i} differs from row_scale's")
        w_f = model.dec.stage_convs(i)[-1][4][0].to(torch.bfloat16)
        ht = h.transpose(1, 2).contiguous()
        ops = 2 * BATCH * t * c * c * conv.taps
        ms = cuda_ms(lambda: int8_conv1d(h, conv, 5, LRELU_SLOPE, sx=sx), 10)
        row = {"stage": i, "T": t, "C": c, "k": conv.taps, "dilation": 5,
               "ulps": ulps,
               "max_abs_err": (got.float() - want.float()).abs().max().item(),
               "ms": ms,
               "ms_with_fused_amax": cuda_ms(lambda: int8_conv1d(
                   h, conv, 5, LRELU_SLOPE, sx=sx, amax_out=amax), 10),
               "library_ms": cuda_ms(lambda: F.conv1d(
                   ht, w_f, padding=25, dilation=5), 10),
               "gop": ops / 1e9, "tops": ops / ms / 1e9}
        print("Q1 conv " + json.dumps(row))
        out["conv"].append(row)

        # ---- the whole int8 stage: 18 conv launches, its input's scale
        # finished from the upsample's abs-max, its output's taken by the
        # last conv, as the decoder runs it
        stage = red.stages[i]
        h_amax, amax = abs_max(h), torch.zeros(BATCH, device="cuda")
        got = mrf_stage_int8(h, stage, kind, ds, x_amax=h_amax,
                             amax_out=amax)
        want = mrf_stage_int8_reference(h, stage, kind, ds)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        check(bool(torch.isfinite(got).all()) and err <= scale / 127.0,
              f"int8 stage {i}: max |kernel - plain| {err} > {scale} / 127")
        check(torch.equal(finish(amax), row_scale_reference(got, LRELU_SLOPE)),
              f"the stage {i} output's fused abs-max differs from "
              f"row_scale's")
        ops, nbytes = stage_cost(BATCH, t, c, ks, ds, kind, 2, 1)
        # the cuDNN bf16 convolutions of the same stage, one F.conv1d per
        # conv and nothing else: the library's time for the products
        convs = [(w.to(torch.bfloat16), k, d)
                 for branch, k, dils in zip(model.dec.stage_convs(i), ks, ds)
                 for (w, _), d in zip(branch, conv_dilations(kind, dils))]

        def library():
            for w, k, d in convs:
                F.conv1d(ht, w, padding=(k - 1) * d // 2, dilation=d)

        ms = cuda_ms(lambda: mrf_stage_int8(h, stage, kind, ds,
                                            x_amax=h_amax, amax_out=amax), 5)
        row = {"stage": i, "B": BATCH, "T": t, "C": c, "max_abs_err": err,
               "max_abs_plain": scale, "ms": ms,
               "k1_bf16_ms": k1_bf16_rows[i]["ms"],
               "plain_ms": cuda_ms(lambda: mrf_stage_int8_reference(
                   h, stage, kind, ds), 1),
               "library_ms": cuda_ms(library, 3),
               "bound_ms": 1e3 * max(ops / PEAK_INT8_OPS,
                                     nbytes / PEAK_BYTES),
               "gop": ops / 1e9, "tops": ops / ms / 1e9,
               "one_tile_ms": one_tile_ms(
                   lambda x: mrf_stage_int8(x, stage, kind, ds), h)}
        print("Q1 int8 stage " + json.dumps(row))
        out["stage"].append(row)
    return out


@torch.no_grad()
def phase_chain():
    """K3: both chains against their plain version at the probe's shapes,
    then the probe itself, which is K3's own path (its launches are counted
    over the probe alone), and the same hops through the library's products
    with PyTorch requantisation between them, timed here only."""
    from wetts_tpu_torch.ops.int8_chain import (
        HOPS,
        ROW_TILE,
        matmul_chain,
        matmul_chain_reference,
    )
    from wetts_tpu_torch.tools import probe_int8

    m, k = probe_int8.M, probe_int8.K
    ops = 2 * m * k * k * HOPS
    out = {}
    for name, dtype, peak in (("bf16", torch.bfloat16, PEAK_BF16_FLOPS),
                              ("int8", torch.int8, PEAK_INT8_OPS)):
        a, w = probe_int8.chain_inputs(dtype)
        got = matmul_chain(a, w)
        want = matmul_chain_reference(a, w)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        if dtype == torch.int8:
            check(torch.equal(got, want), f"int8 chain differs from the "
                                          f"plain version (max {err})")
        else:
            # f32 sums in another order, rounded to bf16 after every hop: a
            # sum near a rounding boundary lands one bf16 step apart and the
            # later hops spread it; within 2 ** -5 of max |plain|
            check(bool(torch.isfinite(got).all())
                  and err <= 2.0 ** -5 * scale,
                  f"bf16 chain: max |kernel - plain| {err} > {scale} / 32")
        nbytes = (2 * a.numel() + w.numel()) * a.element_size()
        w_bytes = w.numel() * w.element_size()
        out[name] = {
            "max_abs_err": err, "max_abs_plain": scale,
            # w is read once per 256-row tile and hop; the design before
            # read it once per 64 (int8) or 32 (bf16) rows and hop
            "w_l2_bytes": -(-m // ROW_TILE) * HOPS * w_bytes,
            "w_l2_bytes_before": m // (64 if name == "int8" else 32) * HOPS
                                 * w_bytes,
            "plain_ms": cuda_ms(lambda: matmul_chain_reference(a, w), 2),
            "bound_ms": 1e3 * max(ops / peak, nbytes / PEAK_BYTES)}

    # the library's products, requantised by PyTorch between the hops
    def library_int8(a, w):
        for _ in range(HOPS):
            a = torch.clamp(torch._int_mm(a, w) >> 10, -127, 127).to(
                torch.int8)
        return a

    def library_bf16(a, w):
        for _ in range(HOPS):
            a = (torch.matmul(a, w).float() * (1.0 / 32.0)).to(
                torch.bfloat16)
        return a

    a8, w8 = probe_int8.chain_inputs(torch.int8)
    check(torch.equal(library_int8(a8, w8), matmul_chain(a8, w8)),
          "torch._int_mm's chain differs from K3's")
    out["int8"]["library_ms"] = cuda_ms(lambda: library_int8(a8, w8), 5)
    a16, w16 = probe_int8.chain_inputs(torch.bfloat16)
    out["bf16"]["library_ms"] = cuda_ms(lambda: library_bf16(a16, w16), 5)

    # ---- K3's own path: the probe's timing of each chain, the count
    # zeroed just before it and read just after
    for name, (a, w) in (("bf16", (a16, w16)), ("int8", (a8, w8))):
        matmul_chain.launches = 0
        ms = probe_int8.time_chain(lambda: matmul_chain(a, w))
        out[name]["launches"] = matmul_chain.launches
        out[name]["ms"] = ms
        out[name]["tera_ops_per_s"] = probe_int8.chain_rate(ms)
    out["int8_speedup"] = out["bf16"]["ms"] / out["int8"]["ms"]
    print("K3 chain " + json.dumps(out))
    return out


def phase_model_stages(model, mrf_ms: dict):
    """Device time of the three synthesis stages for a batch of 4 at the
    64-phone text bucket and the 352-frame decode bucket, flow and decode
    at each precision, and the MRF stages' share of each decode (their time
    from the kernel phases, at the same shapes)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randint(1, N_PHONES, (BATCH, 64), device="cuda", generator=gen)
    xl = torch.full((BATCH,), 64, device="cuda")
    sid = torch.arange(BATCH, device="cuda") % N_SPEAKERS
    with torch.inference_mode():
        z_p, _, _, _, g = model.encode_prior(x, xl, sid, max_frames=768,
                                             generator=gen)
        z_p = z_p[:, :FRAME_BUCKET]
        mask = torch.ones(BATCH, FRAME_BUCKET, 1, device="cuda")
        out = {"encode_prior_ms": cuda_ms(lambda: model.encode_prior(
            x, xl, sid, max_frames=768, generator=gen), 3)}
        for precision, ms in mrf_ms.items():
            z = model.flow_reverse(z_p, mask, g, precision)
            out[precision] = {
                "flow_reverse_ms": cuda_ms(lambda: model.flow_reverse(
                    z_p, mask, g, precision), 3),
                "decode_ms": cuda_ms(lambda: model.decode(
                    z, g, precision=precision), 3)}
            out[precision]["mrf_share_of_decode"] = \
                ms / out[precision]["decode_ms"]
    return out


@torch.no_grad()
def random_init_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded random weights at the scale of torch's default init, for runs
    without a checkpoint: every tensor U(-1/sqrt(fan_in), +), with fan_in =
    numel / shape[0]; LayerNorm gamma 1 and beta 0; weight-norm g = ||v||,
    then folded. Nothing is left at zero, so no path is hidden. The
    posterior encoder draws last, so that a synthesizer's other weights (and
    with them the durations the serving phases see) are those this function
    gave before the model held one."""
    from wetts_tpu_torch.models.layers import WeightNormed

    gen = torch.Generator().manual_seed(seed)
    for name, p in sorted(model.named_parameters(),
                          key=lambda item: item[0].startswith("enc_q.")):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("gamma", "beta", "weight_g"):
            continue
        fan_in = p.numel() // p.shape[0] if p.ndim > 1 else p.numel()
        bound = fan_in ** -0.5
        p.copy_(torch.rand(p.shape, generator=gen) * 2 * bound - bound)
    for module in model.modules():
        if isinstance(module, WeightNormed) and hasattr(module, "weight_v"):
            v = module.weight_v
            module.weight_g.copy_(torch.sqrt(
                (v * v).sum(dim=tuple(range(1, v.ndim)), keepdim=True)))
            module.fold_()
    return model


def build_engine(cfg, **options):
    from wetts_tpu_torch.models.synthesizer import Synthesizer
    from wetts_tpu_torch.serving.engine import SynthesisEngine

    model = random_init_(Synthesizer(cfg), SEED)
    phone2id = {"sil": 0, **{f"p{i}": i for i in range(1, N_PHONES)}}
    speakers = {f"spk{i}": i for i in range(N_SPEAKERS)}
    # random weights predict about one frame per phone; length_scale 5
    # brings durations near real speech's (~6 frames of 11.6 ms per phone)
    engine = SynthesisEngine(cfg, model, phone2id, speakers, seed=SEED,
                             length_scale=5.0, **options)
    check(engine.device == torch.device("cuda"), "engine not on cuda")
    return engine


def phrase(rng, n: int) -> str:
    return " ".join(f"p{int(i)}" for i in rng.integers(1, N_PHONES, n))


def utterance_batches(engine, rng, n_batches: int):
    """Batches of BATCH raw-phone requests of 55-63 phones (with the `sil`
    head at most 64, the 64-phone text bucket): about 4 s of audio each at
    the engine's length_scale; the decode buckets they reach are reported."""
    return [([engine.text_to_phone_ids(phrase(rng, int(n)))
              for n in rng.integers(55, 64, BATCH)],
             [engine.speaker_id(f"spk{i}") for i in range(BATCH)])
            for _ in range(n_batches)]


def phase_synthesis(engine, batches):
    """Batches of ~4 s requests through SynthesisEngine on the GPU, one
    after another; the rate is all audio over all the wall time."""
    from wetts_tpu_torch.serving.engine import TEXT_BUCKETS, FRAMES_PER_TEXT

    audios, batch_ms, buckets = [], [], {}
    t0 = time.perf_counter()
    for ids, sids in batches:
        tb = time.perf_counter()
        out = engine.synthesize_ids_batch(ids, sids)
        batch_ms.append(1e3 * (time.perf_counter() - tb))
        audios += out
        fb = engine._frame_bucket(max(a.size for a in out) // engine.hop,
                                  TEXT_BUCKETS[1] * FRAMES_PER_TEXT)
        buckets[fb] = buckets.get(fb, 0) + 1
    wall = time.perf_counter() - t0
    for a in audios:
        check(a.ndim == 1 and a.size > 0 and a.size % engine.hop == 0,
              f"audio shape {a.shape}")
        check(bool(np.isfinite(a).all()) and float(np.abs(a).max()) > 0,
              "audio not finite or all zero")
    seconds = sum(a.size for a in audios) / engine.sample_rate
    return audios, {"requests": len(audios), "batch": BATCH,
                    "audio_s": seconds,
                    "mean_request_audio_s": seconds / len(audios),
                    "wall_s": wall, "audio_s_per_s": seconds / wall,
                    "batch_ms_p50": float(np.median(batch_ms)),
                    "batch_ms_min": min(batch_ms),
                    "batch_ms_max": max(batch_ms),
                    "frame_buckets": {str(k): v
                                      for k, v in sorted(buckets.items())}}


def phase_serving(engine, rng):
    """3 requests through TtsServer on 127.0.0.1, then shut it down."""
    from wetts_tpu_torch.serving.server import TtsServer

    server = TtsServer(engine, host="127.0.0.1", port=0)
    server.start_background()
    try:
        for i in range(3):
            query = urllib.parse.urlencode(
                {"text": phrase(rng, 15 + 5 * i), "name": f"spk{i}"})
            url = f"http://127.0.0.1:{server.port}/?{query}"
            with urllib.request.urlopen(url, timeout=120) as resp:
                check(resp.status == 200, f"HTTP status {resp.status}")
                body = json.loads(resp.read())
            check(body["status"] == "ok", f"server said {body}")
            wav = base64.b64decode(body["audio"])
            check(wav[:4] == b"RIFF", "response is not a RIFF WAV")
            with wave.open(io.BytesIO(wav)) as w:
                check(w.getframerate() == engine.sample_rate,
                      f"WAV rate {w.getframerate()}")
                check(w.getnframes() > 0, "empty WAV")
    finally:
        server.shutdown()


def phase_reference(engine):
    """The GPU path against the plain path on the CPU at the engine's
    precision, same weights and input, deterministic scales (0, 1, 0). f32:
    both sides f32 with TF32 off, within the CPU parity tests' 2e-4. bf16
    and int8: bf16 glue on both sides, rounded at other places by the
    kernels, cuDNN and the CPU's convolutions, so within the JAX package's
    own drift bound for a reduced decoder (3e-2 on the tanh-bounded wave)
    and correlation above 0.99."""
    precision = engine.precision
    x = torch.arange(1, 13)[None] % (N_PHONES - 1) + 1
    xl = torch.tensor([12])
    sid = torch.tensor([1])
    cpu_model = copy.deepcopy(engine.model).cpu()
    with torch.inference_mode():
        want, wl, _ = cpu_model.infer(x, xl, sid, 0.0, 1.0, 0.0, 64,
                                      precision=precision)
        got, gl, _ = engine.model.infer(x.cuda(), xl.cuda(), sid.cuda(),
                                        0.0, 1.0, 0.0, 64,
                                        precision=precision)
    check(torch.equal(gl.cpu(), wl), f"y_lengths {gl.tolist()} vs {wl.tolist()}")
    got = got.cpu()
    err = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all()) and got.shape == want.shape
          and got.dtype == torch.float32, "GPU audio not finite or misshapen")
    corr = float(torch.corrcoef(torch.stack([got.flatten(),
                                             want.flatten()]))[0, 1])
    check(err <= (2e-4 if precision == "f32" else 3e-2) and corr > 0.99,
          f"{precision}: GPU vs CPU audio max diff {err}, correlation {corr}")
    return {"precision": precision, "y_len": gl.tolist(), "max_abs_err": err,
            "correlation": corr, "max_abs_plain": want.abs().max().item()}


def mas_inputs(b: int, t_spec: int, t_text: int, gen: torch.Generator):
    """Scores and a ragged mask on the GPU: spec lengths in
    [max(t_text, t_spec / 2), t_spec], text lengths in [t_text / 2, t_text]
    (never above the spec length), one utterance at full size."""
    neg_cent = torch.randn(b, t_spec, t_text, device="cuda", generator=gen) * 3
    t_ys = torch.randint(max(t_text, t_spec // 2), t_spec + 1, (b,),
                         device="cuda", generator=gen)
    t_xs = torch.minimum(torch.randint(max(t_text // 2, 1), t_text + 1, (b,),
                                       device="cuda", generator=gen), t_ys)
    t_ys[0], t_xs[0] = t_spec, t_text
    mask = ((torch.arange(t_spec, device="cuda")[None, :, None]
             < t_ys[:, None, None])
            & (torch.arange(t_text, device="cuda")[None, None, :]
               < t_xs[:, None, None])).float()
    return neg_cent, mask


def mas_bound_ms(mask: torch.Tensor) -> float:
    """The least time the card could take for MAS on these inputs: the
    larger of bytes over the memory rate (the valid cells of neg_cent read
    once, the path written once, 4 bytes each) and operations over the f32
    rate (one add and one max per valid cell). Bytes win by far."""
    valid = float(mask.sum().item())
    nbytes = 4.0 * (valid + mask.numel())
    return 1e3 * max(nbytes / PEAK_BYTES, 2.0 * valid / PEAK_F32_FLOPS)


def phase_mas_kernel():
    """K2 against its plain version at the v1 training shapes: exactly equal;
    both timed with CUDA events (the plain version, a Python loop of T_spec
    steps, once)."""
    from wetts_tpu_torch.ops.mas import (
        _launch,
        _prepare,
        maximum_path,
        maximum_path_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for b, t_spec, t_text in MAS_SHAPES:
        neg_cent, mask = mas_inputs(b, t_spec, t_text, gen)
        got = maximum_path(neg_cent, mask)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = maximum_path_reference(neg_cent, mask)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        n_diff = int((got != want).sum().item())
        check(n_diff == 0, f"K2 {b}x{t_spec}x{t_text}: {n_diff} cells differ "
                           f"from the plain version")
        check(bool((got.sum(-1) == mask[:, :, 0]).all()),
              "K2: not one text position per valid frame")
        ms = cuda_ms(lambda: maximum_path(neg_cent, mask), 20)
        # the kernel's launch alone, on prepared inputs: `ms` above also
        # holds the wrapper's plain PyTorch part (lengths, the -1e9 fill,
        # the final `* mask`), a dozen small launches that the host may
        # enqueue more slowly than the card runs them
        masked, _, t_xs, t_ys = _prepare(neg_cent, mask)
        kernel_ms = cuda_ms(lambda: _launch(masked, t_xs, t_ys), 20)
        row = {"B": b, "T_spec": t_spec, "T_text": t_text,
               "max_abs_err": float((got - want).abs().max().item()),
               "ms": ms, "plain_ms": plain_ms,
               "bound_ms": mas_bound_ms(mask), "bound_by": "bytes",
               "kernel_ms": kernel_ms,
               "us_per_row": 1e3 * kernel_ms / t_spec}
        print("K2 shape " + json.dumps(row))
        rows.append(row)
    return rows


def write_corpus(root: str, rng) -> tuple:
    """A seeded synthetic corpus: noise-like 22.05 kHz wavs of 3.5-11 s (so
    that frame buckets from 400 up to 1000 occur), phones from the 64-phone
    table at about one per 5 frames, 4 speakers. Returns the paths of the
    manifest, the phone table and the speaker table."""
    from wetts_tpu_torch.utils.wav import write_wav

    os.makedirs(os.path.join(root, "wavs"))
    lines = []
    for i in range(TRAIN_UTTERANCES):
        seconds = 3.5 + 7.5 * i / (TRAIN_UTTERANCES - 1)
        n = int(seconds * 22050)
        wav = (0.1 * rng.standard_normal(n)).astype(np.float32)
        path = os.path.join(root, "wavs", f"u{i}.wav")
        write_wav(path, wav, 22050)
        n_phones = min(190, max(10, n // 256 // 5))
        lines.append(f"{path}|spk{i % N_SPEAKERS}|{phrase(rng, n_phones)}")
    paths = [os.path.join(root, name)
             for name in ("train.txt", "phones.txt", "speakers.txt")]
    with open(paths[0], "w") as f:
        f.write("\n".join(lines))
    with open(paths[1], "w") as f:
        f.write("sil 0\n" + "\n".join(f"p{i} {i}"
                                        for i in range(1, N_PHONES)))
    with open(paths[2], "w") as f:
        f.write("\n".join(f"spk{i} {i}" for i in range(N_SPEAKERS)))
    return tuple(paths)


@contextlib.contextmanager
def observed_training(record: dict):
    """While active, notes for every training step its frame bucket and the
    host time at which it had finished on the device, and keeps the first
    step's MAS inputs. The trainer and the synthesizer look both functions up
    by name in their own modules, which is where they are wrapped."""
    from wetts_tpu_torch.models import synthesizer
    from wetts_tpu_torch.train import trainer

    real_mas, real_step = synthesizer.maximum_path, trainer.train_step

    def mas(neg_cent, mask):
        record.setdefault("mas_inputs", (neg_cent, mask))
        if "mas_events" in record:
            record["mas_events"][0].record()
        path = real_mas(neg_cent, mask)
        if "mas_events" in record:
            record["mas_events"][1].record()
        return path

    def step(cfg, state, batch, generator=None, mark=None):
        metrics = real_step(cfg, state, batch, generator, mark)
        torch.cuda.synchronize()
        record.setdefault("step_end", []).append(time.perf_counter())
        record.setdefault("buckets", []).append(
            batch["wav"].shape[1] // cfg.data.hop_length)
        return metrics

    synthesizer.maximum_path, trainer.train_step = mas, step
    try:
        yield
    finally:
        synthesizer.maximum_path, trainer.train_step = real_mas, real_step


WATCHED_PARAMS = {
    "G": ("dec.conv_pre.weight", "dec.ups.0.weight_g", "dec.ups.0.weight_v",
          "dec.resblocks.0.convs1.0.weight_g",
          "dec.resblocks.11.convs2.2.weight_v",
          "flow.flows.0.enc.in_layers.0.weight_g",
          "flow.flows.0.enc.in_layers.0.weight_v",
          "enc_q.enc.in_layers.15.weight_v", "enc_p.emb.weight",
          "dp.flows.1.proj.weight", "emb_g.weight"),
    "D": ("discriminators.0.convs.0.weight_g",
          "discriminators.0.conv_post.weight_v",
          "discriminators.5.convs.4.weight_v"),
}


def phase_training(cfg):
    """The training main path at v1's full width through `Trainer`."""
    from wetts_tpu_torch.models.mrf import mrf_stage
    from wetts_tpu_torch.ops.mas import maximum_path, maximum_path_reference
    from wetts_tpu_torch.train.step import train_step
    from wetts_tpu_torch.train.trainer import Trainer

    cfg = copy.deepcopy(cfg)
    cfg.train.log_interval = 1  # every step's metrics reach metrics.jsonl
    n_first = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS
    record = {}
    with tempfile.TemporaryDirectory(prefix="wetts_smoke_") as root:
        manifest, phones, speakers = write_corpus(
            root, np.random.default_rng(SEED))
        model_dir = os.path.join(root, "exp")
        trainer = Trainer(copy.deepcopy(cfg), model_dir, manifest, phones,
                          speakers)
        check(trainer.device.type == "cuda", "trainer not on cuda")
        check(trainer.start_step == 0 and len(trainer.dataset)
              == TRAIN_UTTERANCES, "corpus or start step")
        nets = {"G": trainer.state.net_g, "D": trainer.state.net_d}
        random_init_(nets["G"], SEED)
        random_init_(nets["D"], SEED + 1)
        start = {k: {n: dict(net.named_parameters())[n].detach().clone()
                     for n in WATCHED_PARAMS[k]} for k, net in nets.items()}

        # ---- the main path: counts zeroed just before, read just after ----
        torch.cuda.reset_peak_memory_stats()
        maximum_path.launches = mrf_stage.launches = 0
        with observed_training(record):
            t0 = time.perf_counter()
            check(trainer.train(max_steps=n_first) == n_first, "steps taken")
            t_first = time.perf_counter()
            resumed = Trainer(copy.deepcopy(cfg), model_dir, manifest, phones,
                              speakers)
            check(resumed.start_step == n_first,
                  f"resumed at {resumed.start_step}, not {n_first}")
            check(resumed.train(max_steps=n_first + 1) == n_first + 1,
                  "the resumed trainer's step")
        launches = {"mas": maximum_path.launches, "mrf": mrf_stage.launches}
        peak_bytes = torch.cuda.max_memory_allocated()
        n_steps = n_first + 1
        check(launches["mas"] == n_steps,
              f"K2 launches {launches['mas']} != {n_steps} steps")
        check(launches["mrf"] == 0,
              f"K1 launched {launches['mrf']} times while training")

        with open(os.path.join(model_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        check([m["step"] for m in metrics] == list(range(1, n_steps + 1)),
              "metrics.jsonl steps")
        for m in metrics:
            for key, value in m.items():
                check(bool(np.isfinite(value)), f"step {m['step']} {key}")
        for key in ("loss/g_total", "loss/disc"):
            values = [m[key] for m in metrics]
            check(len(set(values)) == len(values), f"{key} repeats: {values}")
        for k, net in nets.items():
            params = dict(net.named_parameters())
            for name, before in start[k].items():
                check(not torch.equal(params[name].detach(), before),
                      f"{k} parameter {name} did not move")
        resumed_params = dict(resumed.state.net_g.named_parameters())
        check(not torch.equal(resumed_params["dec.conv_pre.weight"],
                              dict(nets["G"].named_parameters())
                              ["dec.conv_pre.weight"]),
              "the resumed trainer's step changed nothing")

        # ---- the first step's own alignment: K2 against the plain version
        neg_cent, mask = record["mas_inputs"]
        check(torch.equal(maximum_path(neg_cent, mask),
                          maximum_path_reference(neg_cent, mask)),
              "K2 differs from the plain version on the first step's inputs")

        # ---- one more step, split by phase with CUDA events ----
        names = ("start", "g_forward", "d_update", "g_update")
        events = {n: torch.cuda.Event(enable_timing=True) for n in names}
        record["mas_events"] = [torch.cuda.Event(enable_timing=True)
                                for _ in range(2)]
        batch = resumed._feed(next(iter(resumed.batcher(1))))
        with observed_training(record):
            events["start"].record()
            train_step(resumed.cfg, resumed.state, batch, resumed.generator,
                       mark=lambda name: events[name].record())
        torch.cuda.synchronize()
        split = {f"{b}_ms": events[a].elapsed_time(events[b])
                 for a, b in zip(names[:-1], names[1:])}
        split["mas_ms"] = record["mas_events"][0].elapsed_time(
            record["mas_events"][1])
        split["frames"] = batch["wav"].shape[1] // cfg.data.hop_length
        split["T_text"] = batch["phone_ids"].shape[1]

    ends = record["step_end"]
    step_ms = [1e3 * (b - a) for a, b in zip([t0] + ends[:n_first - 1],
                                             ends[:n_first])]
    timed = step_ms[TRAIN_WARMUP_STEPS:]
    return {
        "steps": n_steps, "batch": cfg.train.batch_size,
        "segment_size": cfg.train.segment_size,
        "frame_buckets": record["buckets"][:n_steps],
        "T_text_first_step": neg_cent.shape[2],
        "warmup_step_ms": step_ms[:TRAIN_WARMUP_STEPS],
        "step_ms_p50": float(np.median(timed)), "step_ms_min": min(timed),
        "step_ms_max": max(timed),
        "steps_per_s": len(timed) / (sum(timed) / 1e3),
        "save_s": t_first - ends[n_first - 1],
        "peak_memory_bytes": peak_bytes,
        "loss_g_total": [m["loss/g_total"] for m in metrics],
        "loss_disc": [m["loss/disc"] for m in metrics],
        "split_of_one_step": split,
    }, launches


def phase_train_reference():
    """One training step on the GPU (K2 in the forward, the differentiable
    MRF route in the decoder) against the CPU at a small size: the same
    seeded weights, every draw replaced by a fixed pattern and dropout off.
    The alignment must be exactly equal and every loss within rel 1e-3 (f32
    sums taken in another order)."""
    from wetts_tpu_torch.config import Config
    from wetts_tpu_torch.models.mrf import mrf_stage
    from wetts_tpu_torch.ops import random
    from wetts_tpu_torch.ops.mas import maximum_path
    from wetts_tpu_torch.train.state import GANTrainState
    from wetts_tpu_torch.train.step import build_models, train_step

    cfg = Config.from_dict({
        "train": {"segment_size": 256},
        "data": {"filter_length": 64, "hop_length": 16, "win_length": 64,
                 "n_mel_channels": 20},
        "model": {"inter_channels": 32, "hidden_channels": 32,
                  "filter_channels": 64, "n_layers": 2,
                  "resblock_kernel_sizes": [3, 5],
                  "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]],
                  "upsample_rates": [4, 4], "upsample_initial_channel": 64,
                  "upsample_kernel_sizes": [8, 8], "gin_channels": 16},
        "num_phones": 24, "num_speakers": 3})
    net_g, net_d = build_models(cfg)
    random_init_(net_g, SEED)
    random_init_(net_d, SEED + 1)
    gen = torch.Generator().manual_seed(SEED)
    batch = {"phone_ids": torch.randint(1, 24, (2, 9), generator=gen),
             "text_lengths": torch.tensor([9, 7]),
             "wav": torch.randn(2, 24 * 16, generator=gen) * 0.3,
             "spec_lengths": torch.tensor([24, 21]),
             "sid": torch.tensor([0, 1])}

    def pattern(shape, device, dtype=torch.float32, generator=None):
        n = torch.Size(shape).numel()
        return (0.4 * torch.sin(0.7 * torch.arange(n, dtype=torch.float32)
                                + 0.37)).reshape(tuple(shape)).to(device,
                                                                  dtype)

    def constant(shape, device, dtype=torch.float32, generator=None):
        return torch.full(tuple(shape), 0.37, device=device, dtype=dtype)

    def run(device):
        g, d = copy.deepcopy(net_g).to(device), copy.deepcopy(net_d).to(device)
        attn = []
        handle = g.register_forward_hook(
            lambda module, args, out: attn.append(out["attn"].cpu()))
        metrics = train_step(cfg, GANTrainState.create(cfg, g, d),
                             {k: v.to(device) for k, v in batch.items()})
        handle.remove()
        return {k: float(v) for k, v in metrics.items()}, attn[0]

    saved = random.normal, random.uniform, random.dropout
    random.normal, random.uniform = pattern, constant
    random.dropout = lambda x, p, training, generator=None: x
    try:
        want, want_attn = run("cpu")
        before = maximum_path.launches, mrf_stage.launches
        got, got_attn = run("cuda")
    finally:
        random.normal, random.uniform, random.dropout = saved
    check(maximum_path.launches - before[0] == 1, "K2 launches in one step")
    check(mrf_stage.launches == before[1], "K1 launched while training")
    check(torch.equal(got_attn, want_attn), "GPU and CPU alignments differ")
    worst = 0.0
    for key, value in want.items():
        rel = abs(got[key] - value) / max(abs(value), 1e-12)
        check(np.isfinite(got[key]) and rel <= 1e-3,
              f"{key}: GPU {got[key]} vs CPU {value}")
        worst = max(worst, rel)
    return {"max_rel_err": worst, "loss_g_total": got["loss/g_total"],
            "attn_frames": int(got_attn.sum().item())}


def serve_precision(cfg, name: str, options: dict, rng_seed: int,
                    with_server: bool):
    """The serving main path at one precision: a fresh engine (the same
    seeded weights and noise stream every time), warm-up, then the batches
    (and the HTTP requests) with every kernel's count zeroed just before
    and read just after."""
    from wetts_tpu_torch.models.mrf import mrf_stage
    from wetts_tpu_torch.models.quant import (
        int8_conv1d,
        int8_conv_transpose1d,
        row_scale,
    )

    counters = {"mrf_stage": mrf_stage, "int8_conv": int8_conv1d,
                "int8_conv_transpose": int8_conv_transpose1d,
                "int8_row_scale": row_scale}
    engine = build_engine(cfg, **options)
    check(engine.precision == name, f"engine precision {engine.precision}")
    rng = np.random.default_rng(rng_seed)
    # warm-up (cuDNN plans, allocator), then the main path's requests
    engine.synthesize(phrase(rng, 10))
    for ids, sids in utterance_batches(engine, rng, 2):
        engine.synthesize_ids_batch(ids, sids)
    batches = utterance_batches(engine, rng, SYNTH_BATCHES[name])
    for fn in counters.values():
        fn.launches = 0
    engine.stage_times.reset()
    audios, synth = phase_synthesis(engine, batches)
    if with_server:
        phase_serving(engine, rng)
    launches = {k: fn.launches for k, fn in counters.items()}
    report = engine.stage_times.report()
    n_decode = report["decode"]["n"]
    m = cfg.model
    mrf_convs = sum(len(conv_dilations(m.resblock, d))
                    for d in m.resblock_dilation_sizes
                    ) * len(m.upsample_rates)
    ups = len(m.upsample_rates)
    # int8: one row scale, of conv_pre's output; every other scale comes
    # from an epilogue (the upsamples' and the convs')
    want = {"f32": (mrf_convs, 0, 0, 0), "bf16": (mrf_convs, 0, 0, 0),
            "int8": (0, mrf_convs, ups, 1)}[name]
    for (key, got), per_decode in zip(launches.items(), want):
        check(got == per_decode * n_decode,
              f"{name}: {key} launched {got} times, not {per_decode} x "
              f"{n_decode} decodes")
    synth.update(precision=name, decodes=n_decode, launches=launches)
    print("synthesis " + json.dumps(synth))
    print(f"stage_times {name} " + json.dumps(
        {k: {"n": v["n"], "mean_ms": v["mean_ms"], "p50_ms": v["p50_ms"]}
         for k, v in report.items()}))
    print("reference " + json.dumps(phase_reference(engine)))
    return audios, synth, launches


def compare_with_f32(name: str, audios, exact, corr_floor: float) -> dict:
    """A reduced engine's requests against the f32 engine's on the same
    seed: equal lengths (the duration path stays f32), and audio within the
    JAX package's own bounds for its reduced decoders
    (tests/test_hifigan_fast.py: max abs err < 3e-2 on the tanh-bounded
    wave; correlation > 0.995 for bf16, > 0.99 for int8)."""
    n = min(len(audios), len(exact))
    check([a.size for a in audios[:n]] == [e.size for e in exact[:n]],
          f"{name}: y_lengths differ from the f32 engine's")
    err = max(float(np.abs(a - e).max()) for a, e in zip(audios, exact))
    got, want = np.concatenate(audios[:n]), np.concatenate(exact[:n])
    corr = float(np.corrcoef(got, want)[0, 1])
    out = {"precision": name, "requests": n, "max_abs_err": err,
           "correlation": corr, "max_abs_f32": float(np.abs(want).max())}
    print("drift " + json.dumps(out))
    check(err < 3e-2 and corr > corr_floor,
          f"{name} audio drifts from f32: max abs err {err}, correlation "
          f"{corr}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from wetts_tpu_torch.config import Config
    from wetts_tpu_torch.utils import cuda_build

    # f32 throughout: cuDNN convolutions would otherwise run in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(cuda_build.build, KERNELS))  # one nvcc each, together
    print(f"built {list(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        lines = [ln.strip() for ln in cuda_build.compiler_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        for line in sorted(set(lines)):
            print(f"ptxas {name}: {line}")

    cfg = Config.from_json(CONFIG)
    cfg.num_phones, cfg.num_speakers = N_PHONES, N_SPEAKERS
    engine = build_engine(cfg)
    rows = phase_kernels(engine.model, cfg.model)
    rows_bf16 = phase_kernels(engine.model, cfg.model, torch.bfloat16)
    q = phase_int8_kernels(engine.model, cfg.model, rows_bf16)
    print("model_stages " + json.dumps(phase_model_stages(engine.model, {
        "f32": sum(r["ms"] for r in rows),
        "bf16": sum(r["ms"] for r in rows_bf16),
        "int8": sum(r["ms"] for r in q["stage"])})))
    del engine
    torch.cuda.empty_cache()
    chain = phase_chain()

    # ---- the serving main path, once per precision (same seeds each time)
    exact, synth, launches = serve_precision(cfg, "f32", {}, SEED, True)
    half, synth_bf16, launches_bf16 = serve_precision(
        cfg, "bf16", {"half": True}, SEED, False)
    quant, synth_int8, launches_int8 = serve_precision(
        cfg, "int8", {"quantize": True}, SEED, True)
    compare_with_f32("bf16", half, exact, 0.995)
    compare_with_f32("int8", quant, exact, 0.99)
    print("serving " + json.dumps({
        s["precision"]: {"audio_s_per_s": s["audio_s_per_s"],
                         "batch_ms_p50": s["batch_ms_p50"]}
        for s in (synth, synth_bf16, synth_int8)}))
    torch.cuda.empty_cache()

    mas_rows = phase_mas_kernel()
    training, train_launches = phase_training(cfg)
    print("training " + json.dumps(training))
    print("train_reference " + json.dumps(phase_train_reference()))
    v1_rows = [r for r in mas_rows if r["B"] == 32]

    def total(rows_, key):
        return sum(r[key] for r in rows_)

    def kernel(name, source, replaces, n, rows_, bound_by, library=None,
               ms_key="ms"):
        return {"name": name, "route": "cuda",
                "source": f"wetts_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n,
                "max_abs_err": max(r["max_abs_err"] for r in rows_),
                "ms": total(rows_, ms_key),
                "plain_ms": total(rows_, "plain_ms"),
                "bound_ms": total(rows_, "bound_ms"), "bound_by": bound_by,
                "library_ms": library}

    q8 = "wetts_tpu/models/hifigan_fast.py:147"
    # K1's f32 bound is that of three TF32 products per f32 product (the f32
    # CUDA-core bound is in the `K1 stage` lines); its library_ms are the 72
    # F.conv1d calls alone (f32 with cuDNN's TF32 off).
    # ms, plain_ms and bound_ms are sums: K1 and the int8 stage over the four
    # v1 MRF stages (18 convs each; the int8 stage as the decoder runs it,
    # its scales from epilogues), the transposed conv over the four
    # upsamples with their scale work (the first one's row scale included),
    # the row scale over its one call (conv_pre's output), K2 over the
    # three v1 training shapes. The upsamples are bound by bytes (their
    # sum; the first alone by operations, the `bound_by` of each `Q2` line)
    kernels = [
        kernel("mrf_stage", "mrf_stage.cu",
               "wetts_tpu/models/mrf_pallas.py:172", launches["mrf_stage"],
               rows, "operations", total(rows, "library_ms")),
        kernel("mrf_stage_bf16", "mrf_stage.cu",
               "wetts_tpu/models/mrf_pallas.py:172",
               launches_bf16["mrf_stage"], rows_bf16, "operations",
               total(rows_bf16, "library_ms")),
        kernel("mas", "mas.cu", "wetts_tpu/ops/mas_pallas.py:81",
               train_launches["mas"], v1_rows, "bytes"),
        kernel("int8_conv", "int8_mrf_conv.cu", q8,
               launches_int8["int8_conv"], q["stage"], "operations",
               total(q["stage"], "library_ms")),
        kernel("int8_conv_transpose", "int8_mrf_conv.cu", q8,
               launches_int8["int8_conv_transpose"], q["up"], "bytes",
               total(q["up"], "library_ms")),
        kernel("int8_row_scale", "int8_conv.cu",
               "wetts_tpu/models/hifigan_fast.py:141",
               launches_int8["int8_row_scale"], q["scale"], "bytes"),
    ]
    for name in ("int8", "bf16"):
        c = chain[name]
        kernels.append({
            "name": f"int8_chain_{name}", "route": "cuda",
            "source": "wetts_tpu_torch/csrc/int8_chain.cu",
            "replaces": "tools/probe_int8_mxu.py:35",
            "launches": c["launches"], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": "operations",
            "library_ms": c["library_ms"]})
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was launched no time on its "
                                 f"main path")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
