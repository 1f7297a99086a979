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
5b. the model bundle (`phase_bundle`): phase 5's f32 synthesizer saved as a
   released training dir (`G_90000.pth`, a `D_90000.pth` to ignore),
   exported by `bin/export_bundle` (a subprocess, plain and with weight
   norm folded), given a `frontend/` (a random bert-base-wide scorer), and
   served through `cli.model.Model` on the card at f32, bf16 and int8 (load
   time; 256 Mandarin requests of about 4 s, one at a time, each served
   once untimed to warm its shapes and then once timed): the f32 bundle
   equal to the in-memory model within 1 int16 LSB, the folded one within
   the f32 bound, bf16 and int8 within phase 5's bounds; then the `tts` CLI
   (a subprocess on the card, TF32 off as in the script) against the f32
   Model's first request within 1 LSB, `bin/eval_mcd`
   (0.0 against itself; the reduced precisions' MCDs printed) and a Vocos
   bundle at bf16 warning and serving f32;
5c. graph export (`phase_export`): `bin/export_graphs` on the card for
   phase 5's f32 synthesizer (one text bucket, one frame bucket) and a
   vits2_vocos_v1.json decoder, the .pt2 files loaded back: z within 2e-4
   of the live `encode_infer` on the same draws, the audio within 2e-4 *
   max(1, max|live|) of the live decode, the v1 decoder graph launching K1
   through its registered operator 72 times a decode; export seconds,
   bytes, and the graphs' device ms beside the live decoders';
5d. the frontend's trainer (`phase_frontend_train`): `FrontendTrainer` at
   bert-base-chinese's geometry (random weights and vocabulary) for one
   epoch of batches of 32 over synthetic polyphone and prosody lines (a
   prosody-only batch among them), every loss finite; `export_frontend
   --bf16 --verify` into a bundle of phase 5's synthesizer, served by
   `cli.model.Model` on the card;
5e. the native binaries (`phase_native`): g++ builds `tts_main`,
   `http_server_main` and `libwetts_text.so` on the port; `tts_main` on the
   card writes 5d's bundle's audio within 1 LSB of the Model's, and
   `http_server_main` answers `/` (the same audio) and `/stream`;
6. check each precision's GPU audio against the plain path on the CPU on a
   small input;
7. stream text through the Mandarin/English frontend (a random
   bert-base-wide scorer on the card) and both streaming paths at each
   precision, then `/stream` and a burst of batched `/` requests
   (`phase_streaming`);
8. hold VB's kernels (`phase_vocos_kernels`: the Vocos backbone's 18
   split-TF32 GEMMs and 10 row launches) against float64 at the batch
   cell's 8 rows of 1152 latent frames, the GEMMs within a tolerance a
   single TF32 pass fails, and time them beside their plain versions and
   the module path's cuDNN convs; then VITS2 (`phase_vits2`):
   examples/baker/configs/vits2_vocos_v1.json at
   full width (transformer flows, the Vocos decoder with its iSTFT; its
   backbone on `csrc/vocos_backbone.cu`, the CPU's on its modules) against
   the CPU engine, batches of 4 requests of about 4 s, the stages' device
   time beside v1's, voice conversion, both streaming paths through the
   frontend, `/stream` and `/`; then vits2_v1.json (the HiFi-GAN decoder)
   under f32, `half` and `quantize`, held to f32 with v1's bounds;
9. hold kernel K2 (`maximum_path`, monotonic alignment search) exactly equal
   to its plain PyTorch version at the shapes v1 training produces and at a
   wide text, check that a call is one device operation (the nodes of a
   CUDA graph that captures it), and time both, K2 back to back and on the
   device alone, beside its bound (the bytes, or the chain of dependent
   forward steps at the card's maximum SM clock);
10. train: write a seeded synthetic corpus (64 noise-like utterances of
    3.5-11 s, 4 speakers) to a temporary directory, build `Trainer` from
    v1.json as it stands (batch 32, segment 8192, f32) with seeded random
    weights, take 1 warm-up and 4 timed steps, evaluate once on the corpus
    as val manifest with the eval media into a recording summary (K1's 72
    launches per eval-mode decode: each val batch's slice and the media
    utterance; the media decode, after the optimiser's steps, held to a
    decode of the live weights through the plain MRF version), save,
    resume in a second `Trainer` and take one more; check metrics, moved
    parameters, f32 parameters and optimiser state and the first step's
    alignment, and split one step's device time by phase;
11. train VITS2 (`phase_vits2_training`) the same way from
    vits2_vocos_v1.json as it stands (a 24 kHz corpus; noise-scaled MAS,
    the duration discriminator, the multi-period multi-resolution
    discriminator, the Vocos decoder): 1 warm-up and 3 timed steps, a save,
    a resume and one more step; the MAS noise scale checked against its
    schedule, K2 held against its plain version and timed on the first
    step's noised scores, the step split by phase (the duration
    discriminator's update too); then one step of vits2_v1.json;
11b. train VITS2 in bf16 with the WavLM discriminator
    (`phase_bf16_wd_training`): vits2_vocos_v1.json with `bf16_run` and
    `use_wd` set on top, a seeded random WavLM at wavlm-base-plus's
    geometry written as a local HuggingFace directory and read by
    `Trainer(slm_model_dir=...)`; the same steps, save and resume, every
    parameter and optimiser state f32, K2 once a step on f32 scores, the
    step split with the WavLM discriminator's update beside phase 11's f32
    step without it;
11c. data parallelism (`phase_dp`): v1.json at batch 32 through the
    data-parallel step on one NCCL rank, equal to the step without a
    process group up to cuDNN's nondeterminism, host ms of each; two
    processes of 16 rows on the card over gloo against one rank of 32
    (metrics rel 2e-4, parameters 2e-6 at Adam eps 1e-2), K2 on each rank;
12. check one training step on the GPU against the CPU at a small size,
    for VITS-base and for a reduced VITS2 config whose MAS noise moves the
    alignment.
Phases 5, 5b, 5c, 5d, 7 and 8 are the serving main paths, phases 10, 11,
11b and 11c the training main paths and the probe of phase 4 K3's own:
each kernel's
launch count is zeroed just before its path and read just after (under
`half` every MRF stage goes through K1's bf16 instance and no int8 kernel
runs; under `quantize` it is the reverse; the Vocos decoder launches
none of these, but 18 GEMM and 10 row launches of VB a decode;
while training K1 launches only in v1's eval-mode decodes, each val
batch's slice and the media utterance, and K2 once per step and once per
val batch); the `kernels` line sums each kernel's launches over the
serving paths (v1's batches, vits2_v1's batch, the bundle phase's
requests, 5c's exported v1 decoder and 5d's bundle requests; K1 also v1
training's eval; VB phase 8's vits2_vocos_v1 batches) and gives K2 one
entry per training path (v1's with
11c's data-parallel steps,
the VITS2 recipes' at the VITS2 step's shape, and the bf16 + WavLM
discriminator run's at its step's shape).
The last two lines are the kernels JSON and the device JSON. Imports
nothing of JAX; needs a CUDA device.
"""

from __future__ import annotations

import base64
import concurrent.futures
import contextlib
import copy
import http.client
import io
import json
import math
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
KERNELS = ("mrf_stage", "mas", "int8_conv", "int8_mrf_conv", "int8_chain",
           "vocos_backbone")
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
# buckets up to 1000, text padded to a multiple of 16; the `kernels` line
# sums these), a wide text (several DP warps a block), a 1x1 and a square
MAS_V1_SHAPES = ((32, 400, 64), (32, 700, 128), (32, 1000, 208))
MAS_SHAPES = MAS_V1_SHAPES + ((16, 1000, 512), (2, 1, 1), (4, 48, 48))
TRAIN_UTTERANCES, TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS = 64, 1, 4
# streaming: chunks of block + 2 * pad = 60 frames, decoded alone (the first)
# or stacked up to 64 rows; a stream is STREAM_CLAUSES clauses of about 4 s
# (one encode; 1 + 64 + the rest chunks), STREAM_RUNS streams per precision
# and path after a warm-up one: enough for a p95 of first-chunk latency and
# of RTF (a percentile of fewer samples is their maximum, no tail)
CHUNK_BATCHES = (1, 64)
STREAM_CLAUSES, STREAM_RUNS, STREAM_HANZI = 8, 20, 20
# the English word of a streamed text; its ARPAbet phones are in the
# streaming phone table, so its ids reach the synthesizer
STREAM_ENGLISH = "hello"
# ARPAbet: 15 vowels with stress 0-2 and 24 consonants, what G2pEn gives
ARPABET = [f"{v}{s}" for v in ("AA AE AH AO AW AY EH ER EY IH IY OW OY UH "
                               "UW").split() for s in range(3)] + (
    "B CH D DH F G HH JH K L M N NG P R S SH T TH V W Y Z ZH").split()
# audio seconds a streamed clause is given: the phase sets length_scale so
# that its clauses of STREAM_HANZI hanzi (some 60 phones and prosody marks)
# average this long, within 10%, on the seeded weights
STREAM_CLAUSE_S = 4.0
# VITS2 (phase_vits2): the published Vocos recipe at full width, and its
# HiFi-GAN twin; batches of BATCH requests, streams of a few clauses
VITS2_CONFIG = os.path.join(ROOT, "examples", "baker", "configs",
                            "vits2_vocos_v1.json")
VITS2_HIFIGAN_CONFIG = os.path.join(ROOT, "examples", "baker", "configs",
                                    "vits2_v1.json")
VITS2_BATCHES, VITS2_STREAMS, VITS2_STREAM_CLAUSES = 8, 4, 4


def vits2_config(path: str, n_phones: int):
    from wetts_tpu_torch.config import Config

    cfg = Config.from_json(path)
    cfg.num_phones, cfg.num_speakers = n_phones, N_SPEAKERS
    return cfg


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


def stage_shapes(gen_cfg, frames: int = FRAME_BUCKET):
    """(stage, T, C) of the four MRF stages at `frames` decoder frames (the
    decode bucket unless told otherwise)."""
    t = frames
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
        stage = (model.dec.form("bf16").stages[i] if bf16
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
    red = model.dec.form("int8")
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
    at each precision of `mrf_ms`, and the MRF stages' share of each decode
    (their time from the kernel phases, at the same shapes; None for a
    decoder without them)."""
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
            if ms is not None:
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


@torch.no_grad()
def phase_chunk_kernels(model, gen_cfg):
    """K1 (f32 and bf16), the int8 stage (Q1, its input's scale from an
    abs-max, its output's taken in the last conv's epilogue), the int8
    upsample Q2 and the row scale Q0 against their plain versions at the
    shapes the streamed decoder gives them: B = 1 (the first chunk) and
    B = 64 (a full tail stack) of 60-frame chunks, so T = 480, 3840, 7680
    and 15360 samples, none of them a multiple of the 128-row tile. The
    tolerances are those of the kernel phases. Timed back to back (`ms`),
    the plain version once."""
    from wetts_tpu_torch.models.layers import LRELU_SLOPE
    from wetts_tpu_torch.models.mrf import (
        mrf_stage,
        mrf_stage_int8,
        mrf_stage_int8_reference,
        mrf_stage_reference,
        pack_stage,
    )
    from wetts_tpu_torch.models.quant import (
        int8_conv_transpose1d,
        int8_conv_transpose1d_reference,
        row_scale,
        row_scale_reference,
        upsample_scale_per_phase,
    )
    from wetts_tpu_torch.serving.streaming import DEFAULT_BLOCK, DEFAULT_PAD

    frames = DEFAULT_BLOCK + 2 * DEFAULT_PAD
    kind = gen_cfg.resblock
    ks = tuple(gen_cfg.resblock_kernel_sizes)
    ds = tuple(tuple(d) for d in gen_cfg.resblock_dilation_sizes)
    red8, red16 = model.dec.form("int8"), model.dec.form("bf16")
    per_phase = upsample_scale_per_phase(
        gen_cfg.upsample_initial_channel, gen_cfg.upsample_rates, frames)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for b in CHUNK_BATCHES:
        x = torch.randn(b, frames, gen_cfg.upsample_initial_channel,
                        device="cuda", generator=gen).to(torch.bfloat16)
        check(torch.equal(row_scale(x, LRELU_SLOPE),
                          row_scale_reference(x, LRELU_SLOPE)),
              f"the row scale at B={b} differs from the plain version")
        rows.append({"kernel": "int8_row_scale", "B": b, "T": frames,
                     "C": x.shape[2], "max_abs_err": 0.0,
                     "ms": cuda_ms(lambda: row_scale(x, LRELU_SLOPE), 10)})
        for i, t, c in stage_shapes(gen_cfg, frames):
            # Q2: the upsample into this stage, from a finished row scale
            up = red8.quantized_up(model.dec, i, per_phase[i])
            sx = row_scale(x, LRELU_SLOPE)
            got = int8_conv_transpose1d(x, up, LRELU_SLOPE, sx=sx)
            want = int8_conv_transpose1d_reference(x, up, LRELU_SLOPE)
            ulps = _ulps(got, want)
            check(got.shape == (b, t, c) and ulps <= 2.0,
                  f"int8 upsample {i} at B={b}: {ulps} ulps from the plain "
                  f"version")
            rows.append({
                "kernel": "int8_conv_transpose", "stage": i, "B": b,
                "T_in": x.shape[1], "T": t, "C": c, "ulps": ulps,
                "max_abs_err": (got.float() - want.float()).abs().max().item(),
                "ms": cuda_ms(lambda: int8_conv_transpose1d(
                    x, up, LRELU_SLOPE, sx=sx), 5)})
            x = torch.randn(b, t, c, device="cuda", generator=gen)
            for name, dtype in (("mrf_stage", torch.float32),
                                ("mrf_stage_bf16", torch.bfloat16)):
                stage = (model.dec.stage_convs(i) if dtype == torch.float32
                         else red16.stages[i])
                packed = pack_stage(stage)
                h = x.to(dtype)
                got = mrf_stage(h, stage, kind, ks, ds, packed=packed)
                want = mrf_stage_reference(h, stage, kind, ks, ds)
                err = (got.float() - want.float()).abs().max().item()
                scale = max(1.0, want.float().abs().max().item())
                tol = (8 * BF16_ULP if dtype == torch.bfloat16
                       else 1e-4) * scale
                check(bool(torch.isfinite(got).all()) and err <= tol,
                      f"{name} stage {i} at B={b}: max |kernel - plain| "
                      f"{err} > {tol}")
                rows.append({
                    "kernel": name, "stage": i, "B": b, "T": t, "C": c,
                    "max_abs_err": err, "max_abs_plain": scale,
                    "ms": cuda_ms(lambda: mrf_stage(
                        h, stage, kind, ks, ds, packed=packed), 5),
                    "plain_ms": cuda_ms(lambda: mrf_stage_reference(
                        h, stage, kind, ks, ds), 1)})
            h = x.to(torch.bfloat16)
            x_amax = torch.nn.functional.leaky_relu(
                h, LRELU_SLOPE).abs().amax(dim=(1, 2)).float()
            amax = torch.zeros(b, device="cuda")
            got = mrf_stage_int8(h, red8.stages[i], kind, ds, x_amax=x_amax,
                                 amax_out=amax)
            want = mrf_stage_int8_reference(h, red8.stages[i], kind, ds)
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            check(bool(torch.isfinite(got).all()) and err <= scale / 127.0,
                  f"int8 stage {i} at B={b}: max |kernel - plain| {err} > "
                  f"{scale} / 127")
            rows.append({
                "kernel": "int8_conv", "stage": i, "B": b, "T": t, "C": c,
                "max_abs_err": err, "max_abs_plain": scale,
                "ms": cuda_ms(lambda: mrf_stage_int8(
                    h, red8.stages[i], kind, ds, x_amax=x_amax,
                    amax_out=amax), 5),
                "plain_ms": cuda_ms(lambda: mrf_stage_int8_reference(
                    h, red8.stages[i], kind, ds), 1)})
            x = got
    for row in rows:
        print("chunk kernel " + json.dumps(row))
    return rows


def frontend_tables():
    """The Mandarin/English frontend's tables from the port's vendored
    assets: (vocab, lexicon, pinyin2id, pinyin2phones, English G2P,
    phone2id). The vocabulary is [PAD], [CLS], [SEP], [UNK] and the hanzi
    of pinyin_dict.txt (bert-base-chinese's vocab.txt is not in the repo);
    the phone table is `sil`, phones.list, the prosody marks #0-#4 and the
    ARPAbet phones of English words."""
    from wetts_tpu_torch.assets import cmudict_path, lexicon_path
    from wetts_tpu_torch.cli.frontend import read_list
    from wetts_tpu_torch.text.g2p_en import G2pEn
    from wetts_tpu_torch.text.lexicon import Lexicon, read_pinyin2phones

    lexicon = Lexicon(lexicon_path("pinyin_dict.txt"))
    vocab = {t: i for i, t in enumerate(
        ["[PAD]", "[CLS]", "[SEP]", "[UNK]"] + list(lexicon.words()))}
    with open(lexicon_path("phones.list"), encoding="utf8") as f:
        phones = (["sil"] + f.read().split() + [f"#{i}" for i in range(5)]
                  + ARPABET)
    return (vocab, lexicon, read_list(lexicon_path("polyphone.txt")),
            read_pinyin2phones(lexicon_path("lexicon.txt")),
            G2pEn(cmudict_path()), {p: i for i, p in enumerate(phones)})


def build_engine(cfg, precision: str = "f32"):
    from wetts_tpu_torch.models.synthesizer import Synthesizer
    from wetts_tpu_torch.serving.engine import SynthesisEngine

    model = random_init_(Synthesizer(cfg), SEED)
    phone2id = {"sil": 0, **{f"p{i}": i for i in range(1, N_PHONES)}}
    speakers = {f"spk{i}": i for i in range(N_SPEAKERS)}
    # random weights predict about one frame per phone; length_scale 5
    # brings durations near real speech's (~6 frames of 11.6 ms per phone)
    engine = SynthesisEngine(cfg, model, phone2id, speakers, seed=SEED,
                             length_scale=5.0, precision=precision)
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


# the least latency of one dependent f32 operation (fmaxf, fadd) on
# Hopper's CUDA cores, in SM cycles
DEPENDENT_OP_CYCLES = 4


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    return 1e6 * float(out)


def mas_bound(neg_cent: torch.Tensor, mask: torch.Tensor, clock_hz: float):
    """The least time the card could take for MAS on these inputs, in ms,
    and what sets it: the larger of
    - bytes over the memory rate: the valid cells of neg_cent and of the
      mask read once (the -1e9 fill needs both), every cell of the path
      written once;
    - the dependency chain: the longest utterance's t_spec rows, each a
      forward step (a dependent fmaxf then fadd), at the card's maximum SM
      clock.
    A recurrence of t_spec rows cannot beat the chain however many SMs
    share the batch. The backtracking is not in the chain: once the forward
    pass is done, the walk is a composition of per-row maps (index ->
    index - bit), which pointer doubling takes in log2(t_spec) rounds."""
    valid = float(mask.bool().sum().item())
    t_spec = int(mask[:, :, 0].float().sum(dim=1).max().item())
    nbytes = ((neg_cent.element_size() + mask.element_size()) * valid
              + 4.0 * mask.numel())
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    chain_ms = 1e3 * max(t_spec, 1) * 2 * DEPENDENT_OP_CYCLES / clock_hz
    return {"bound_ms": max(bytes_ms, chain_ms),
            "bound_by": "bytes" if bytes_ms >= chain_ms else "chain",
            "bytes_ms": bytes_ms, "chain_ms": chain_ms}


def kernels_per_call(fn) -> int:
    """Device operations (kernels, copies, memsets) one fn() call queues,
    counted exactly: the call is captured into a CUDA graph, which records
    every operation it queues and refuses a host synchronisation, and
    `cuGraphGetNodes` counts the graph's nodes. torch.profiler's
    CUPTI trace of the card dropped kernel records on an H100 (a whole
    session's, or one or two of four calls', before and after the training
    phases), so it cannot count them."""
    import ctypes

    fn()  # allocations and lazy set-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    libcuda = ctypes.CDLL("libcuda.so.1")
    n_nodes = ctypes.c_size_t(0)
    err = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                  None, ctypes.byref(n_nodes))
    check(err == 0, f"cuGraphGetNodes failed ({err})")
    return n_nodes.value


def mas_row(neg_cent: torch.Tensor, mask: torch.Tensor, clock_hz: float,
            what: str) -> dict:
    """K2 against its plain version on these inputs: exactly equal, one
    text position per valid frame, one device operation a call (captured
    in a CUDA graph); the call timed
    back to back and on the device alone (the plain version, a Python loop
    of T_spec steps, once), beside its bound."""
    from wetts_tpu_torch.ops.mas import maximum_path, maximum_path_reference

    b, t_spec, t_text = neg_cent.shape
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
    check(n_diff == 0, f"K2 {what} {b}x{t_spec}x{t_text}: {n_diff} cells "
                       f"differ from the plain version")
    check(bool((got.sum(-1) == mask[:, :, 0]).all()),
          f"K2 {what}: not one text position per valid frame")
    call = lambda: maximum_path(neg_cent, mask)  # noqa: E731
    n_kernels = kernels_per_call(call)
    check(n_kernels == 1, f"K2 {what} {b}x{t_spec}x{t_text}: {n_kernels} "
                          f"device operations a call, not 1")
    dev_ms = device_ms(call)
    return {"B": b, "T_spec": t_spec, "T_text": t_text,
            "max_abs_err": float((got - want).abs().max().item()),
            "ms": cuda_ms(call, 20), "device_ms": dev_ms,
            "plain_ms": plain_ms, **mas_bound(neg_cent, mask, clock_hz),
            "kernels_per_call": n_kernels,
            "us_per_row": 1e3 * dev_ms / t_spec}


def phase_mas_kernel():
    """K2 against its plain version at the v1 training shapes and a wide
    one (`mas_row`)."""
    clock_hz = max_sm_clock_hz()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for b, t_spec, t_text in MAS_SHAPES:
        row = mas_row(*mas_inputs(b, t_spec, t_text, gen), clock_hz,
                      "random scores")
        print("K2 shape " + json.dumps(row))
        rows.append(row)
    return rows


def write_corpus(root: str, rng, sampling_rate: int) -> tuple:
    """A seeded synthetic corpus: noise-like wavs of 3.5-11 s at
    `sampling_rate` (so that frame buckets from 400 up to 1000 occur at hop
    256), phones from the 64-phone table at about one per 5 frames, 4
    speakers. Returns the paths of the manifest, the phone table and the
    speaker table."""
    from wetts_tpu_torch.utils.wav import write_wav

    os.makedirs(os.path.join(root, "wavs"))
    lines = []
    for i in range(TRAIN_UTTERANCES):
        seconds = 3.5 + 7.5 * i / (TRAIN_UTTERANCES - 1)
        n = int(seconds * sampling_rate)
        wav = (0.1 * rng.standard_normal(n)).astype(np.float32)
        path = os.path.join(root, "wavs", f"u{i}.wav")
        write_wav(path, wav, sampling_rate)
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


class RecordingSummary:
    """A `Trainer` summary that keeps what it is given, in place of a
    TensorBoard writer (the card's machine has no `tensorboard`):
    `scalars[step]` the last values per tag, `images` and `audio` as
    (step, tag, array) in order, `flushes` the number of flushes."""

    def __init__(self):
        self.scalar_steps, self.images, self.audio_clips = {}, [], []
        self.flushes = 0

    def scalars(self, step: int, values: dict) -> None:
        self.scalar_steps.setdefault(step, {}).update(values)

    def image(self, step: int, tag: str, img) -> None:
        self.images.append((step, tag, img))

    def audio(self, step: int, tag: str, wav, sample_rate: int) -> None:
        self.audio_clips.append((step, tag, wav, sample_rate))

    def flush(self) -> None:
        self.flushes += 1


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
        record.setdefault("mas_dtypes", set()).add(neg_cent.dtype)
        if "mas_events" in record:
            record["mas_events"][0].record()
        path = real_mas(neg_cent, mask)
        if "mas_events" in record:
            record["mas_events"][1].record()
        return path

    def step(cfg, state, batch, generator=None, mark=None,
             slm_feature_fn=None):
        metrics = real_step(cfg, state, batch, generator, mark,
                            slm_feature_fn)
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
# vits2_vocos_v1: the Vocos decoder, the transformer flow, the mel posterior
# encoder, the SDP's flows (reached by the duration term through logw), the
# resolution and period discriminators, the duration discriminator
VITS2_WATCHED_PARAMS = {
    "G": ("dec.in_conv.weight", "dec.layers.0.pw_conv1.weight",
          "dec.layers.7.dw_conv.weight", "dec.out_conv.weight",
          "flow.flows.0.pre_transformer.attn_layers.0.conv_q.weight",
          "flow.flows.0.enc.in_layers.0.weight_v",
          "enc_q.enc.in_layers.15.weight_v", "enc_p.emb.weight",
          "dp.flows.1.proj.weight", "dp.post_flows.1.proj.weight",
          "emb_g.weight"),
    "D": ("discriminators.0.band_convs.0.0.weight_v",
          "discriminators.1.band_convs.4.4.weight_g",
          "discriminators.2.conv_post.weight_v",
          "discriminators.7.convs.4.weight_v"),
    "DUR": ("conv_1.weight", "dur_proj.weight", "pre_out_conv_2.weight",
            "output_layer.0.weight"),
}
VITS2_TIMED_STEPS = 3


def train_main_path(cfg, watched: dict, timed_steps: int,
                    slm_model_dir=None, media: bool = False) -> tuple:
    """The training main path through `Trainer` on a seeded synthetic corpus
    at the config's rate: seeded random weights for every network, 1
    warm-up and `timed_steps` timed steps, (with `media`) one `evaluate` on
    the corpus as val manifest with the eval media into a
    `RecordingSummary`, a save, a resume in a second `Trainer` and one
    more step (K2 and K1's counts zeroed just before and read just after);
    then checks of the metrics, the moved parameters, f32 parameters and
    optimiser state, f32 scores into K2, K2 against its plain version on
    the first step's scores (noised under noise-scaled MAS), the media
    audio against a decode of the same weights through the plain MRF
    version, and one more step split by phase with CUDA events.
    `slm_model_dir`: the WavLM directory of a `use_wd` config. Returns (the
    result, K2 and K1's launches, the metrics records, the first step's MAS
    inputs)."""
    from wetts_tpu_torch.models.mrf import mrf_stage
    from wetts_tpu_torch.ops.mas import maximum_path, maximum_path_reference
    from wetts_tpu_torch.train.step import train_step
    from wetts_tpu_torch.train.trainer import Trainer

    cfg = copy.deepcopy(cfg)
    cfg.train.log_interval = 1  # every step's metrics reach metrics.jsonl
    n_first = TRAIN_WARMUP_STEPS + timed_steps
    record = {}
    summary = RecordingSummary()
    with tempfile.TemporaryDirectory(prefix="wetts_smoke_") as root:
        manifest, phones, speakers = write_corpus(
            root, np.random.default_rng(SEED), cfg.data.sampling_rate)
        model_dir = os.path.join(root, "exp")
        trainer = Trainer(copy.deepcopy(cfg), model_dir, manifest, phones,
                          speakers, val_manifest=manifest if media else None,
                          slm_model_dir=slm_model_dir, summary=summary)
        check(trainer.device.type == "cuda", "trainer not on cuda")
        check(trainer.start_step == 0 and len(trainer.dataset)
              == TRAIN_UTTERANCES, "corpus or start step")
        nets = {"G": trainer.state.net_g, "D": trainer.state.net_d,
                "DUR": trainer.state.net_dur_d, "WD": trainer.state.net_wd}
        for k in ("DUR", "WD"):
            check((nets[k] is None) == (k not in watched),
                  f"{k} built against the config")
        for i, k in enumerate(watched):
            random_init_(nets[k], SEED + i)
        start = {k: {n: dict(nets[k].named_parameters())[n].detach().clone()
                     for n in names} for k, names in watched.items()}

        # ---- the main path: counts zeroed just before, read just after ----
        torch.cuda.reset_peak_memory_stats()
        maximum_path.launches = mrf_stage.launches = 0
        with observed_training(record):
            t0 = time.perf_counter()
            check(trainer.train(max_steps=n_first) == n_first, "steps taken")
            t_first = time.perf_counter()
            if media:
                decoded = record_decodes(trainer.state.net_g)
                trainer.evaluate(n_first, epoch=1)
                del trainer.state.net_g.decode
                t_eval = time.perf_counter()
            resumed = Trainer(copy.deepcopy(cfg), model_dir, manifest, phones,
                              speakers, slm_model_dir=slm_model_dir,
                              summary=RecordingSummary())
            check(resumed.start_step == n_first,
                  f"resumed at {resumed.start_step}, not {n_first}")
            check(resumed.train(max_steps=n_first + 1) == n_first + 1,
                  "the resumed trainer's step")
        launches = {"mas": maximum_path.launches, "mrf": mrf_stage.launches}
        peak_bytes = torch.cuda.max_memory_allocated()
        n_steps = n_first + 1
        # the evaluate's forward of each val batch aligns too, and its
        # decoder runs in eval mode: K1 for each val batch's slice and the
        # media utterance, 72 launches each for v1
        n_val = min(8, len(trainer._val_batcher)) if media else 0
        check(launches["mas"] == n_steps + n_val,
              f"K2 launches {launches['mas']} != {n_steps} steps + {n_val} "
              f"val batches")
        check(record["mas_dtypes"] == {torch.float32},
              f"K2 given scores of {record['mas_dtypes']}")
        n_decodes = n_val + 1 if media else 0
        want_mrf = launches_per_decode(cfg.model, "f32")[0] * n_decodes
        check(launches["mrf"] == want_mrf,
              f"K1 launched {launches['mrf']} times while training, not "
              f"{want_mrf} ({n_decodes} eval-mode decodes)")
        for state in (trainer.state, resumed.state):
            for name, net, opt in state.nets():
                check(all(p.dtype == torch.float32
                          for p in net.parameters())
                      and all(v.dtype == torch.float32
                              for per in opt.state.values()
                              for v in per.values() if v.is_floating_point()),
                      f"{name}: parameters or optimiser state not f32")

        with open(os.path.join(model_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        train_metrics = [m for m in metrics if "loss/g_total" in m]
        check([m["step"] for m in train_metrics]
              == list(range(1, n_steps + 1)), "metrics.jsonl steps")
        for m in metrics:
            for key, value in m.items():
                check(bool(np.isfinite(value)), f"step {m['step']} {key}")
        for key in ("loss/g_total", "loss/disc"):
            values = [m[key] for m in train_metrics]
            check(len(set(values)) == len(values), f"{key} repeats: {values}")
        for k, names in watched.items():
            params = dict(nets[k].named_parameters())
            for name, before in start[k].items():
                check(not torch.equal(params[name].detach(), before),
                      f"{k} parameter {name} did not move")
        resumed_params = dict(resumed.state.net_g.named_parameters())
        first_g = watched["G"][0]
        check(not torch.equal(resumed_params[first_g],
                              dict(nets["G"].named_parameters())[first_g]),
              "the resumed trainer's step changed nothing")
        media_result = (check_media(trainer, summary, decoded, n_first)
                        if media else None)

        # ---- the first step's own alignment: K2 against the plain version
        neg_cent, mask = record["mas_inputs"]
        check(torch.equal(maximum_path(neg_cent, mask),
                          maximum_path_reference(neg_cent, mask)),
              "K2 differs from the plain version on the first step's inputs")

        # ---- one more step, split by phase with CUDA events ----
        names = ("start", "g_forward", "d_update") + (
            ("dur_d_update",) if "DUR" in watched else ()) + (
            ("wd_update",) if "WD" in watched else ()) + ("g_update",)
        events = {n: torch.cuda.Event(enable_timing=True) for n in names}
        record["mas_events"] = [torch.cuda.Event(enable_timing=True)
                                for _ in range(2)]
        batch = resumed._feed(next(iter(resumed.batcher(1))))
        with observed_training(record):
            events["start"].record()
            train_step(resumed.cfg, resumed.state, batch, resumed.generator,
                       mark=lambda name: events[name].record(),
                       slm_feature_fn=resumed.slm_feature_fn)
        torch.cuda.synchronize()
        split = {f"{b}_ms": events[a].elapsed_time(events[b])
                 for a, b in zip(names[:-1], names[1:])}
        split["mas_ms"] = record["mas_events"][0].elapsed_time(
            record["mas_events"][1])
        split["step_ms"] = events["start"].elapsed_time(events["g_update"])
        split["mas_share"] = split["mas_ms"] / split["step_ms"]
        split["frames"] = batch["wav"].shape[1] // cfg.data.hop_length
        split["T_text"] = batch["phone_ids"].shape[1]

    ends = record["step_end"]
    step_ms = [1e3 * (b - a) for a, b in zip([t0] + ends[:n_first - 1],
                                             ends[:n_first])]
    timed = step_ms[TRAIN_WARMUP_STEPS:]
    result = {
        "steps": n_steps, "batch": cfg.train.batch_size,
        "segment_size": cfg.train.segment_size,
        "bf16": cfg.train.bf16_run or cfg.train.fp16_run,
        "frame_buckets": record["buckets"][:n_steps],
        "T_text_first_step": neg_cent.shape[2],
        "warmup_step_ms": step_ms[:TRAIN_WARMUP_STEPS],
        "step_ms_p50": float(np.median(timed)), "step_ms_min": min(timed),
        "step_ms_max": max(timed),
        "steps_per_s": len(timed) / (sum(timed) / 1e3),
        "save_s": t_first - ends[n_first - 1],
        "peak_memory_bytes": peak_bytes,
        "loss_g_total": [m["loss/g_total"] for m in train_metrics],
        "loss_disc": [m["loss/disc"] for m in train_metrics],
        "split_of_one_step": split,
    }
    if media:
        result["eval_s"] = t_eval - t_first
        result["media"] = media_result
        result["val_batches"] = n_val
    return result, launches, train_metrics, (neg_cent, mask)


def record_decodes(net_g) -> list:
    """Shadow `net_g.decode` with a wrapper that keeps each call's (z, g,
    audio); `del net_g.decode` restores the method."""
    calls = []
    real = net_g.decode

    def decode(z, g=None, sid=None, precision="f32"):
        out = real(z, g, sid, precision)
        calls.append((z, g, out))
        return out

    net_g.decode = decode
    return calls


@torch.no_grad()
def check_media(trainer, summary, decoded, step: int) -> dict:
    """The eval media of `trainer.evaluate`: the three tags at `step`, and
    `gen/audio` (decoded through K1 after the optimiser's steps) against a
    decode of the same latent through the plain MRF version from the live
    weight_g / weight_v (the decoder in train() mode), within K1's f32
    tolerance 1e-4 * max(1, max|plain|): a folded buffer or a packed K1
    copy left stale by the steps would differ."""
    tags = ([tag for st, tag, _, _ in summary.audio_clips if st == step]
            + [tag for st, tag, _ in summary.images if st == step])
    check(sorted(tags) == ["gen/alignment", "gen/audio", "gen/mel"],
          f"eval media tags {tags}")
    check({"val/mel_l1", "val/kl", "val/dur"} <= set(
        summary.scalar_steps[step]), "eval scalars")
    check(len(decoded) == 1, f"{len(decoded)} media decodes, not 1")
    (z, g, audio), = decoded
    (_, _, wav, _), = [c for c in summary.audio_clips if c[0] == step]
    check(np.array_equal(wav, audio[0, :wav.size, 0].cpu().numpy()),
          "gen/audio is not the decoder's output")
    net_g = trainer.state.net_g
    net_g.dec.train()  # the differentiable chain: mrf_stage_reference
    want = net_g.decode(z, g)[0, :wav.size, 0]
    net_g.dec.eval()
    err = float((audio[0, :wav.size, 0] - want).abs().max())
    bound = 1e-4 * max(1.0, float(want.abs().max()))
    check(err <= bound, f"media audio {err:.3e} from the plain decode "
                        f"(bound {bound:.3e})")
    return {"samples": int(wav.size), "max_abs_err": err, "bound": bound,
            "peak": float(np.abs(wav).max())}


def phase_training(cfg):
    """The training main path at v1's full width through `Trainer`, with
    one evaluate and its eval media (K1 in every eval-mode decode)."""
    result, launches, _, _ = train_main_path(cfg, WATCHED_PARAMS,
                                             TRAIN_TIMED_STEPS, media=True)
    return result, launches


def phase_vits2_training(card: str):
    """VITS2 training at the full width and depth of vits2_vocos_v1.json
    (`train_main_path`: the mel posterior encoder, the transformer flows,
    noise-scaled MAS through K2, the SDP, the duration discriminator, the
    multi-period multi-resolution discriminator, the Vocos decoder with its
    iSTFT), its MAS noise scale checked against the schedule, K2 timed at
    the step's noised scores; then one step of vits2_v1.json (HiFi-GAN,
    the multi-period discriminator) through `Trainer`. Returns (the result,
    K2's launches on both main paths, K2's row at the VITS2 step's
    shape)."""
    from wetts_tpu_torch.models.mrf import mrf_stage
    from wetts_tpu_torch.ops.mas import maximum_path
    from wetts_tpu_torch.train.trainer import Trainer

    cfg = vits2_config(VITS2_CONFIG, N_PHONES)
    result, launches, metrics, (neg_cent, mask) = train_main_path(
        cfg, VITS2_WATCHED_PARAMS, VITS2_TIMED_STEPS)
    m = cfg.model
    for rec in metrics:
        want = max(m.mas_noise_scale_initial
                   - m.noise_scale_delta * (rec["step"] - 1), 0.0)
        got = rec["train/mas_noise_scale"]
        check(abs(got - want) <= 1e-6 * want,
              f"step {rec['step']}: MAS noise scale {got}, not {want}")
        check(all(k in rec for k in ("loss/dur_disc", "loss/dur_gen")),
              f"step {rec['step']}: no duration discriminator losses")
    result["mas_noise_scale"] = [r["train/mas_noise_scale"] for r in metrics]
    result["loss_dur_disc"] = [r["loss/dur_disc"] for r in metrics]
    result["loss_dur_gen"] = [r["loss/dur_gen"] for r in metrics]
    k2 = mas_row(neg_cent, mask, max_sm_clock_hz(), "VITS2 noised scores")
    print("K2 vits2 shape " + json.dumps(k2))
    result["mas_device_ms"] = k2["device_ms"]
    result["mas_share_of_step_p50"] = k2["device_ms"] / result["step_ms_p50"]
    result["card"] = card

    # ---- one step of vits2_v1.json as it stands ----
    hcfg = vits2_config(VITS2_HIFIGAN_CONFIG, N_PHONES)
    hcfg.train.log_interval = 1
    with tempfile.TemporaryDirectory(prefix="wetts_smoke_") as root:
        paths = write_corpus(root, np.random.default_rng(SEED + 1),
                             hcfg.data.sampling_rate)
        trainer = Trainer(hcfg, os.path.join(root, "exp"), *paths)
        for i, net in enumerate((trainer.state.net_g, trainer.state.net_d,
                                 trainer.state.net_dur_d)):
            random_init_(net, SEED + i)
        maximum_path.launches = mrf_stage.launches = 0
        t0 = time.perf_counter()
        check(trainer.train(max_steps=1) == 1, "vits2_v1: the step")
        step_s = time.perf_counter() - t0
        hifigan = {"mas": maximum_path.launches, "mrf": mrf_stage.launches}
        with open(os.path.join(root, "exp", "metrics.jsonl")) as f:
            (rec,) = [json.loads(line) for line in f]
    check(hifigan == {"mas": 1, "mrf": 0},
          f"vits2_v1: K2 / K1 launches {hifigan} in one step")
    check(all(np.isfinite(v) for v in rec.values())
          and {"loss/dur_disc", "loss/dur_gen"} <= set(rec),
          f"vits2_v1: metrics {rec}")
    result["vits2_v1_step"] = {"step_and_save_s": step_s,
                               "loss_g_total": rec["loss/g_total"],
                               "mas_noise_scale":
                                   rec["train/mas_noise_scale"]}
    return result, launches["mas"] + hifigan["mas"], k2


# the bf16 + WavLM discriminator run: VITS2's watched parameters and the
# WavLM discriminator's
VITS2_WD_WATCHED_PARAMS = {
    **VITS2_WATCHED_PARAMS,
    "WD": ("pre.weight_v", "convs.0.weight_g", "convs.2.weight_v",
           "conv_post.weight_v"),
}


def write_wavlm(path: str, seed: int):
    """A WavLM at the default geometry (hidden 768, 12 layers of 12 heads,
    FFN 3072, seven convs of 512: microsoft/wavlm-base-plus's) with seeded
    random weights, written as a local HuggingFace directory: `config.json`
    and `pytorch_model.bin` under HF's state-dict names. Each layer has
    torch's default init drawn from `seed`; the positional conv's v is
    N(0, 1 / fan_in) with g = ||v|| per tap. Returns its config."""
    from wetts_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

    wcfg = WavLMConfig()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = WavLMModel(wcfg)
        conv = model.encoder.pos_conv_embed.conv
        with torch.no_grad():
            v = conv.weight_v
            v.copy_(torch.randn(v.shape) / (v[0].numel() ** 0.5))
            conv.weight_g.copy_(v.square().sum((0, 1), keepdim=True).sqrt())
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(wcfg.to_hf(), f)
    torch.save(model.state_dict(), os.path.join(path, "pytorch_model.bin"))
    return wcfg


def phase_bf16_wd_training(card: str, f32: dict):
    """vits2_vocos_v1.json at full width with `train.bf16_run` and
    `model.use_wd` set on top (no published config sets either), the
    WavLM read by `Trainer._load_slm` from a seeded random WavLM at the
    default geometry written to a temporary directory: `train_main_path`
    (1 warm-up and 3 timed steps, a save, a resume and one more step, the
    step split by phase with the WavLM discriminator's update), the MAS
    noise scale against its schedule, the SLM losses every step, K2 on the
    bf16 step's scores (f32) against its plain version and timed. `f32`:
    the f32 run of the same config without the WavLM branch, from
    `phase_vits2_training` in the same process, as the baseline. Returns
    (the result, K2's launches, K2's row)."""
    cfg = vits2_config(VITS2_CONFIG, N_PHONES)
    cfg.train.bf16_run, cfg.model.use_wd = True, True
    with tempfile.TemporaryDirectory(prefix="wetts_smoke_wavlm_") as root:
        slm_dir = os.path.join(root, "wavlm")
        wcfg = write_wavlm(slm_dir, SEED)
        check((cfg.model.slm_hidden, cfg.model.slm_nlayers)
              == (wcfg.hidden_size, wcfg.num_layers + 1),
              "the config's SLM geometry against the WavLM's")
        t0 = time.perf_counter()
        result, launches, metrics, (neg_cent, mask) = train_main_path(
            cfg, VITS2_WD_WATCHED_PARAMS, VITS2_TIMED_STEPS,
            slm_model_dir=slm_dir)
        result["phase_s"] = time.perf_counter() - t0
    m = cfg.model
    for rec in metrics:
        want = max(m.mas_noise_scale_initial
                   - m.noise_scale_delta * (rec["step"] - 1), 0.0)
        check(abs(rec["train/mas_noise_scale"] - want) <= 1e-6 * want,
              f"bf16 step {rec['step']}: MAS noise scale")
        check({"loss/slm_disc", "loss/slm_feat", "loss/slm_gen",
               "loss/dur_disc", "loss/dur_gen"} <= set(rec),
              f"bf16 step {rec['step']}: no SLM or duration losses")
    for key in ("loss/slm_disc", "loss/slm_feat", "loss/slm_gen"):
        result[key.replace("/", "_")] = [r[key] for r in metrics]
    k2 = mas_row(neg_cent, mask, max_sm_clock_hz(), "VITS2 bf16 scores")
    print("K2 vits2 bf16 shape " + json.dumps(k2))
    result["mas_device_ms"] = k2["device_ms"]
    result["f32_without_wd"] = {
        k: f32[k] for k in ("split_of_one_step", "step_ms_p50",
                            "step_ms_min", "step_ms_max", "steps_per_s",
                            "peak_memory_bytes")}
    result["card"] = card
    return result, launches["mas"], k2


# the reference step's configs, their lengths in frames, and the groups of
# G's gradient (`grad_group`) whose norms are reported but not held to rel
# 1e-3: VITS-base, every group held; and a reduced VITS2 (the mel posterior
# encoder, `pre_conv` flows, the Vocos decoder, the multi-period
# multi-resolution and the duration discriminator, noise-scaled MAS at a
# scale at which the noise moves the alignment; segments of 1280 samples,
# above half the resolution discriminator's largest FFT). In VITS2 the
# stochastic duration predictor's posterior path and the conditioning it
# shares with it are ill-conditioned at these random weights: their
# gradients move by parts in 1e4 when f32 sums are taken in another order,
# so their norms, and G's whole norm that they dominate, are reported only.
# Its main flows (`dp.flows`), which the duration discriminator's term
# reaches, are held with everything else.
REFERENCE_MODEL = {"inter_channels": 32, "hidden_channels": 32,
                   "filter_channels": 64, "n_layers": 2,
                   "resblock_kernel_sizes": [3, 5],
                   "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]],
                   "upsample_rates": [4, 4], "upsample_initial_channel": 64,
                   "upsample_kernel_sizes": [8, 8], "gin_channels": 16}
REFERENCE_CONFIGS = {
    "v1": ({"train": {"segment_size": 256},
            "data": {"filter_length": 64, "hop_length": 16,
                     "win_length": 64, "n_mel_channels": 20},
            "model": REFERENCE_MODEL, "num_phones": 24, "num_speakers": 3},
           (24, 21), ()),
    "vits2": ({"train": {"segment_size": 1280},
               "data": {"filter_length": 64, "hop_length": 16,
                        "win_length": 64, "n_mel_channels": 20,
                        "use_mel_posterior_encoder": True},
               "model": {**REFERENCE_MODEL,
                         "use_mel_posterior_encoder": True,
                         "use_transformer_flows": True,
                         "transformer_flow_type": "pre_conv",
                         "use_noise_scaled_mas": True,
                         "mas_noise_scale_initial": 2.0,
                         "use_duration_discriminator": True,
                         "use_mrd_disc": True, "vocoder_type": "vocos",
                         "vocos_channels": 32, "vocos_h_channels": 48,
                         "vocos_out_channels": 66, "vocos_num_layers": 2,
                         "vocos_istft_config": {
                             "n_fft": 64, "hop_length": 16, "win_length": 64,
                             "center": True}},
               "num_phones": 24, "num_speakers": 3},
              (96, 88), ("dp.cond", "dp.pre", "dp.convs", "dp.proj",
                         "dp.post_pre", "dp.post_convs", "dp.post_proj",
                         "dp.post_flows")),
}


def dp_margins(neg_cent: torch.Tensor, mask: torch.Tensor) -> np.ndarray:
    """|v[y-1, x-1] - v[y-1, x]| for every cell of MAS's forward pass in
    float64 (inf where a side is out of the path's reach): how far each
    cell's choice of predecessor was from a tie."""
    nc = neg_cent.double().cpu().numpy()
    valid = mask.cpu().numpy() > 0
    margins = np.full(nc.shape, np.inf)
    for i in range(nc.shape[0]):
        t_y, t_x = int(valid[i, :, 0].sum()), int(valid[i, 0, :].sum())
        v = np.full(t_x, -np.inf)
        v[0] = nc[i, 0, 0]
        for y in range(1, t_y):
            diag = np.concatenate([[-np.inf], v[:-1]])
            with np.errstate(invalid="ignore"):
                margins[i, y, :t_x] = np.nan_to_num(np.abs(v - diag),
                                                    nan=np.inf)
            v = nc[i, y, :t_x] + np.maximum(v, diag)
    return margins


def grad_group(name: str) -> str:
    """The group of a generator parameter's gradient in `reference_step`:
    its top module, the duration predictor's split one level further."""
    parts = name.split(".")
    return ".".join(parts[:2] if parts[0] == "dp" else parts[:1])


def reference_step(name: str) -> dict:
    """One training step of REFERENCE_CONFIGS[name] on the GPU (K2 in the
    forward, the differentiable MRF route in the decoder) against the CPU:
    the same seeded weights, every draw replaced by a fixed pattern (the
    MAS noise too) and dropout off. The alignment must be exactly equal
    (else the failure names the flipped cells' DP margin); every loss, the
    gradient norms of D and of the duration discriminator, and the norm of
    each `grad_group` of G's gradient within rel 1e-3 (f32 sums taken in
    another order), but for the groups the config reports only; G's whole
    norm too where the config holds every group."""
    from wetts_tpu_torch.config import Config
    from wetts_tpu_torch.models import synthesizer
    from wetts_tpu_torch.models.mrf import mrf_stage
    from wetts_tpu_torch.ops import random
    from wetts_tpu_torch.ops.mas import maximum_path
    from wetts_tpu_torch.train.state import GANTrainState
    from wetts_tpu_torch.train.step import (
        build_models,
        compute_spec,
        train_step,
    )

    cfg_dict, frames, unheld = REFERENCE_CONFIGS[name]
    cfg = Config.from_dict(copy.deepcopy(cfg_dict))
    nets = build_models(cfg)[:3]  # these configs have no WavLM branch
    for i, net in enumerate(nets):
        if net is not None:
            random_init_(net, SEED + i)
    gen = torch.Generator().manual_seed(SEED)
    hop = cfg.data.hop_length
    batch = {"phone_ids": torch.randint(1, 24, (2, 9), generator=gen),
             "text_lengths": torch.tensor([9, 7]),
             "wav": torch.randn(2, frames[0] * hop, generator=gen) * 0.3,
             "spec_lengths": torch.tensor(frames),
             "sid": torch.tensor([0, 1])}

    def pattern(shape, device, dtype=torch.float32, generator=None):
        n = torch.Size(shape).numel()
        return (0.4 * torch.sin(0.7 * torch.arange(n, dtype=torch.float32)
                                + 0.37)).reshape(tuple(shape)).to(device,
                                                                  dtype)

    def constant(shape, device, dtype=torch.float32, generator=None):
        return torch.full(tuple(shape), 0.37, device=device, dtype=dtype)

    real_mas = synthesizer.maximum_path

    def run(device):
        g, d, dur = (None if n is None else copy.deepcopy(n).to(device)
                     for n in nets)
        seen = []

        def mas(neg_cent, mask):
            path = real_mas(neg_cent, mask)
            seen.append((neg_cent.cpu(), mask.cpu(), path.cpu()))
            return path

        synthesizer.maximum_path = mas
        try:
            metrics = train_step(cfg, GANTrainState.create(cfg, g, d, dur),
                                 {k: v.to(device) for k, v in batch.items()})
        finally:
            synthesizer.maximum_path = real_mas
        squares = {}
        for n, p in g.named_parameters():
            if p.grad is not None:
                squares[grad_group(n)] = (squares.get(grad_group(n), 0.0)
                                          + float(p.grad.double().square()
                                                  .sum()))
        metrics = {k: float(v) for k, v in metrics.items()}
        if dur is not None:  # its grads stay from its update
            metrics["grad_norm/dur_d"] = float(torch.linalg.vector_norm(
                torch.stack([p.grad.norm() for p in dur.parameters()
                             if p.grad is not None])))
        metrics.update({f"grad_norm/g/{k}": v ** 0.5
                        for k, v in squares.items()})
        return metrics, seen[0]

    saved = random.normal, random.uniform, random.dropout
    random.normal, random.uniform = pattern, constant
    random.dropout = lambda x, p, training, generator=None: x
    try:
        want, (nc_cpu, mask, want_attn) = run("cpu")
        before = maximum_path.launches, mrf_stage.launches
        got, (nc_gpu, _, got_attn) = run("cuda")
        if cfg.model.use_noise_scaled_mas:  # the CPU forward without noise
            with torch.no_grad():
                plain = copy.deepcopy(nets[0]).train()(
                    batch["phone_ids"], batch["text_lengths"],
                    compute_spec(cfg, batch["wav"]), batch["spec_lengths"],
                    batch["sid"], mas_noise_scale=0.0)["attn"]
            check(not torch.equal(plain, want_attn),
                  f"{name}: the MAS noise did not move the alignment")
    finally:
        random.normal, random.uniform, random.dropout = saved
    check(maximum_path.launches - before[0] == 1,
          f"{name}: K2 launches in one step")
    check(mrf_stage.launches == before[1],
          f"{name}: K1 launched while training")
    if not torch.equal(got_attn, want_attn):
        flipped = (got_attn != want_attn).any(dim=-1)  # rows [B, T_spec]
        margin = dp_margins(nc_cpu, mask)[flipped.numpy()].min()
        check(False, f"{name}: GPU and CPU alignments differ in "
                     f"{int(flipped.sum())} rows; scores differ by at most "
                     f"{float((nc_gpu - nc_cpu).abs().max())}; the flipped "
                     f"rows' smallest DP margin {margin}")
    check(set(got) == set(want), f"{name}: GPU and CPU metrics differ")
    unheld = {f"grad_norm/g/{k}" for k in unheld} | (
        {"grad_norm/g"} if unheld else set())
    check(unheld < set(want), f"{name}: an unheld group is not in G")
    rel_err = {k: abs(got[k] - v) / max(abs(v), 1e-12)
               for k, v in want.items()}
    for key, err in rel_err.items():
        check(np.isfinite(got[key]) and (err <= 1e-3 or key in unheld),
              f"{name} {key}: GPU {got[key]} vs CPU {want[key]}")
    held = [e for k, e in rel_err.items() if k not in unheld]
    return {"max_rel_err_held": max(held), "rel_err": rel_err,
            "unheld": sorted(unheld),
            "loss_g_total": got["loss/g_total"],
            "attn_frames": int(got_attn.sum().item()),
            "max_score_diff": float((nc_gpu - nc_cpu).abs().max())}


def phase_train_reference() -> dict:
    """`reference_step` for VITS-base and the reduced VITS2 config."""
    return {name: reference_step(name) for name in REFERENCE_CONFIGS}


def kernel_counters() -> dict:
    """The serving path's kernel wrappers, each counting its launches."""
    from wetts_tpu_torch.models.mrf import mrf_stage
    from wetts_tpu_torch.models.quant import (
        int8_conv1d,
        int8_conv_transpose1d,
        row_scale,
    )

    return {"mrf_stage": mrf_stage, "int8_conv": int8_conv1d,
            "int8_conv_transpose": int8_conv_transpose1d,
            "int8_row_scale": row_scale}


def launches_per_decode(m, precision: str) -> tuple:
    """kernel_counters()'s launches in one HiFi-GAN decode of model config
    `m` at `precision`: K1 carries every MRF conv in f32 and bf16, Q1 in
    int8, beside one Q2 per upsample and one row scale (of conv_pre's
    output; every other scale comes from an epilogue)."""
    mrf_convs = sum(len(conv_dilations(m.resblock, d))
                    for d in m.resblock_dilation_sizes
                    ) * len(m.upsample_rates)
    return {"f32": (mrf_convs, 0, 0, 0), "bf16": (mrf_convs, 0, 0, 0),
            "int8": (0, mrf_convs, len(m.upsample_rates), 1)}[precision]


def check_launches(what: str, launches: dict, m, precision: str,
                   n_decode: int) -> None:
    for (key, got), per_decode in zip(launches.items(),
                                      launches_per_decode(m, precision)):
        check(got == per_decode * n_decode,
              f"{what}: {key} launched {got} times, not {per_decode} x "
              f"{n_decode} decodes")


def serve_precision(cfg, name: str, rng_seed: int, with_server: bool):
    """The serving main path at one precision: a fresh engine (the same
    seeded weights and noise stream every time), warm-up, then the batches
    (and the HTTP requests) with every kernel's count zeroed just before
    and read just after."""
    counters = kernel_counters()
    engine = build_engine(cfg, precision=name)
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
    check_launches(name, launches, cfg.model, name, n_decode)
    synth.update(precision=name, decodes=n_decode, launches=launches)
    print("synthesis " + json.dumps(synth))
    print(f"stage_times {name} " + json.dumps(
        {k: {"n": v["n"], "mean_ms": v["mean_ms"], "p50_ms": v["p50_ms"]}
         for k, v in report.items()}))
    print("reference " + json.dumps(phase_reference(engine)))
    return audios, synth, launches, engine.model


def spread(xs) -> dict:
    """n, min, p50, max of a sample, and p95 where there are at least 20
    values (of fewer, a p95 is about their maximum, not a tail)."""
    xs = np.asarray(xs, float)
    out = {"n": int(xs.size), "min": float(xs.min()),
           "p50": float(np.percentile(xs, 50)), "max": float(xs.max())}
    if xs.size >= 20:
        out["p95"] = float(np.percentile(xs, 95))
    return out


def stream_text(rng, hanzi, n_clauses: int) -> str:
    """Seeded Mandarin text: clauses of STREAM_HANZI hanzi of the vendored
    dictionary with a comma inside, the second with an English word, each
    ended by 。 (a clause of its own)."""
    clauses = []
    for k in range(n_clauses):
        chars = [hanzi[int(i)]
                 for i in rng.integers(0, len(hanzi), STREAM_HANZI)]
        chars.insert(STREAM_HANZI // 2, "，")
        if k == 1:
            chars.insert(4, STREAM_ENGLISH)
        clauses.append("".join(chars) + "。")
    return "".join(clauses)


class TimedScorer:
    """The frontend's scorer with the host milliseconds of each call (a
    call ends in a copy to the host, so a device sync)."""

    def __init__(self, scorer):
        self.scorer, self.ms = scorer, []

    def __call__(self, token_ids):
        t0 = time.perf_counter()
        out = self.scorer(token_ids)
        self.ms.append(1e3 * (time.perf_counter() - t0))
        return out


def read_stream(port: int, text: str):
    """GET /stream: (int16 samples, ms from the request to the first chunk
    on the host)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    t0 = time.perf_counter()
    conn.request("GET", "/stream?" + urllib.parse.urlencode(
        {"text": text, "name": "spk1"}))
    resp = conn.getresponse()
    check(resp.status == 200 and
          resp.getheader("Transfer-Encoding") == "chunked",
          f"/stream answered {resp.status}")
    first, body = None, b""
    while True:
        data = resp.read1(1 << 16)
        if not data:
            break
        if first is None:
            first = 1e3 * (time.perf_counter() - t0)
        body += data
    conn.close()
    return np.frombuffer(body, np.int16), first


def http_wav(port: int, text: str) -> np.ndarray:
    """GET / and the int16 PCM of the WAV it answers."""
    query = urllib.parse.urlencode({"text": text, "name": "spk1"})
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/?{query}",
                                timeout=120) as resp:
        body = json.loads(resp.read())
    check(body["status"] == "ok", f"server said {body}")
    with wave.open(io.BytesIO(base64.b64decode(body["audio"]))) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def build_frontend():
    """The Mandarin/English frontend on the vendored tables, with a random
    bert-base-chinese-wide FrontendModel behind FrontendScorer on the card:
    (G2pProsody, its TimedScorer, the phone table, the hanzi, the English
    G2P)."""
    from wetts_tpu_torch.frontend.scorer import FrontendScorer
    from wetts_tpu_torch.models.bert_frontend import BertConfig, FrontendModel
    from wetts_tpu_torch.text.frontend import G2pProsody

    vocab, lexicon, pinyin2id, pinyin2phones, g2p_en, phone2id = \
        frontend_tables()
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        bert = FrontendModel(len(pinyin2id), 5, BertConfig())
    scorer = TimedScorer(FrontendScorer(bert))
    frontend = G2pProsody(scorer, vocab, lexicon, pinyin2id, pinyin2phones,
                          g2p_en)
    hanzi = [w for w in lexicon.words() if len(w) == 1]
    return frontend, scorer, phone2id, hanzi, g2p_en


def clause_frames(engine, clauses, length_scale: float) -> list:
    """(frames, the max_frames clip of its text bucket) of each clause at
    scales (0, length_scale, 0), speaker 1."""
    engine.scales = (0.0, length_scale, 0.0)
    got = []
    for c in clauses:
        ids = engine.text_to_phone_ids(c)
        got.append((int(engine._encode_flow([ids], [1])[1][0]),
                    engine._bucket(len(ids))[1]))
    return got


def length_scale_for(frames_at, target: float, what: str) -> float:
    """The length_scale at which frames_at(length_scale) is `target` within
    5% (checked within 10%): durations are ceil(w * length_scale), about
    a * length_scale + b frames, so rescaling by target / frames converges
    in a few steps."""
    length_scale = 0.5
    for _ in range(8):
        frames = frames_at(length_scale)
        if abs(frames / target - 1) < 0.05:
            break
        length_scale *= target / frames
    check(abs(frames / target - 1) < 0.1,
          f"{what} of {frames} frames at length_scale {length_scale}, not "
          f"{target}")
    return length_scale


def phase_streaming(cfg, card: str, fe):
    """Text in, streamed PCM out, at v1's full width: the Mandarin/English
    frontend (vendored tables, a random bert-base-chinese-wide
    FrontendModel behind FrontendScorer on the card) in front of one seeded
    synthesizer shared by an f32, a `half` and a `quantize` engine at
    scales (0, s, 0), where s gives a clause STREAM_CLAUSE_S seconds on
    average. Per precision, STREAM_RUNS seeded texts of
    STREAM_CLAUSES clauses through `stream_synthesize` on both paths, with
    every kernel's count zeroed just before and read just after. Checks:
    each clause's chunks sum to y_len * hop, and no clause reaches its text
    bucket's max_frames clip; the batched-tail stream equals
    the per-chunk one chunk by chunk (2e-4 in f32, TF32 off; 3e-2 in bf16
    and int8, the reduced decoders' bound); K1 carries every chunk in f32
    and bf16, Q0-Q2 every chunk in int8, and the other family none. Then 3
    `/stream` requests (2 bytes a streamed sample) and a burst of 8
    concurrent `/` requests through TtsServer(batching=True) at scales
    (0, 1, 0), each the unbatched engine's audio within 2e-4, with at least
    one batch of two or more. The English word's ARPAbet ids are checked to
    reach the synthesizer."""
    from wetts_tpu_torch.models.synthesizer import Synthesizer
    from wetts_tpu_torch.serving.engine import (
        MAX_CLAUSE_LEN,
        STREAM_TAIL_MAX,
        SynthesisEngine,
    )
    from wetts_tpu_torch.serving.server import TtsServer
    from wetts_tpu_torch.serving.streaming import DEFAULT_BLOCK, DEFAULT_PAD
    from wetts_tpu_torch.text.segmenter import sentence_segment

    frontend, scorer, phone2id, hanzi, g2p_en = fe
    cfg = copy.deepcopy(cfg)
    cfg.num_phones = len(phone2id)
    model = random_init_(Synthesizer(cfg), SEED)
    speakers = {f"spk{i}": i for i in range(N_SPEAKERS)}
    engines = {name: SynthesisEngine(
        cfg, model, phone2id, speakers, frontend=frontend, seed=SEED,
        noise_scale=0.0, noise_scale_w=0.0, precision=name)
        for name in ("f32", "bf16", "int8")}
    rng = np.random.default_rng(SEED)
    counters = kernel_counters()
    m = cfg.model
    hop = model.hop
    probe = engines["f32"]

    def y_lens(clauses, length_scale):
        """Each clause's frames and its bucket's clip (the duration path is
        f32 in every engine, so the three engines give the same)."""
        return clause_frames(probe, clauses, length_scale)

    # length_scale such that a clause averages STREAM_CLAUSE_S
    calibration = sentence_segment(stream_text(rng, hanzi, 4), MAX_CLAUSE_LEN)
    length_scale = length_scale_for(
        lambda ls: float(np.mean([f for f, _ in y_lens(calibration, ls)])),
        STREAM_CLAUSE_S * probe.sample_rate / hop, "clauses")
    for engine in engines.values():
        engine.scales = (0.0, length_scale, 0.0)
    out, texts = {}, [stream_text(rng, hanzi, STREAM_CLAUSES)
                      for _ in range(STREAM_RUNS)]
    frames = {text: y_lens(sentence_segment(text, MAX_CLAUSE_LEN),
                           length_scale) for text in texts}
    check(all(f < clip for v in frames.values() for f, clip in v),
          "a streamed clause reaches its bucket's max_frames clip")
    # the English word's phones reach the synthesizer as ids, in order
    english = [phone2id[p] for p in g2p_en.convert(STREAM_ENGLISH)]
    ids = [probe.text_to_phone_ids(c) for c in sentence_segment(
        texts[0], MAX_CLAUSE_LEN) if STREAM_ENGLISH in c]
    check(len(ids) == 1 and any(
        ids[0][k: k + len(english)] == english for k in range(len(ids[0]))),
        f"the ids of {STREAM_ENGLISH!r} ({english}) are not in its clause's")
    for name, engine in engines.items():
        warm = stream_text(rng, hanzi, 2)
        for tail in (True, False):
            engine.stream_batch_tail = tail
            list(engine.stream_synthesize(warm, "spk1"))
        for fn in counters.values():
            fn.launches = 0
        engine.stage_times.reset()
        scorer.ms.clear()
        runs = {True: [], False: []}
        for text in texts:
            for tail in (True, False):
                engine.stream_batch_tail = tail
                chunks, first = [], None
                t0 = time.perf_counter()
                for chunk in engine.stream_synthesize(text, "spk1"):
                    if first is None:
                        first = 1e3 * (time.perf_counter() - t0)
                    chunks.append(chunk)
                runs[tail].append((chunks, first,
                                   time.perf_counter() - t0))
        launches = {k: fn.launches for k, fn in counters.items()}
        stages = engine.stage_times.report()
        decodes = stages["chunk_wait"]["n"]
        scorer_ms = list(scorer.ms)
        check_launches(f"stream {name}", launches, m, name, decodes)
        tol = 2e-4 if name == "f32" else 3e-2
        worst, chunk_counts, stacks, clause_s = 0.0, [], [], []
        for text, (batched, _, _), (per_chunk, _, _) in zip(
                texts, runs[True], runs[False]):
            check(len(batched) == len(per_chunk) and all(
                a.shape == b.shape for a, b in zip(batched, per_chunk)),
                f"stream {name}: the two paths cut different chunks")
            worst = max(worst, max(float(np.abs(a - b).max())
                                   for a, b in zip(batched, per_chunk)))
            # each clause's chunks sum to its y_len * hop
            lo = 0
            for y_len, _ in frames[text]:
                clause_s.append(y_len * hop / engine.sample_rate)
                n = math.ceil(y_len / DEFAULT_BLOCK)
                got = sum(c.size for c in batched[lo: lo + n])
                check(got == y_len * hop, f"stream {name}: a clause of "
                      f"{y_len} frames streamed {got} samples")
                lo += n
            check(lo == len(batched), f"stream {name}: {len(batched)} "
                  f"chunks, {lo} from the clauses' lengths")
            chunk_counts.append(len(batched))
            stacks.append([1] + [min(STREAM_TAIL_MAX, len(batched) - k)
                                 for k in range(1, len(batched),
                                                STREAM_TAIL_MAX)])
        check(worst <= tol, f"stream {name}: batched tail vs per chunk "
                            f"{worst} > {tol}")
        check(any(STREAM_TAIL_MAX in st for st in stacks),
              f"stream {name}: no tail stack of {STREAM_TAIL_MAX} rows "
              f"({stacks})")
        row = {"precision": name, "card": card, "streams": len(texts),
               "length_scale": length_scale,
               "clauses_per_stream": STREAM_CLAUSES,
               "chunks_per_stream": chunk_counts, "tail_stacks": stacks,
               "clause_s_min": min(clause_s), "clause_s_max": max(clause_s),
               "clause_s_mean": float(np.mean(clause_s)),
               "batched_vs_per_chunk_max_abs": worst, "tolerance": tol,
               "chunk_decodes": decodes, "launches": launches,
               "scorer_ms_per_clause_p50": float(np.median(scorer_ms)),
               "scorer_calls": len(scorer_ms),
               "stage_ms_p50": {k: v["p50_ms"] for k, v in stages.items()},
               "stage_n": {k: v["n"] for k, v in stages.items()}}
        rtf, firsts = {}, {}
        for tail, key in ((True, "batched_tail"), (False, "per_chunk")):
            firsts[tail] = [r[1] for r in runs[tail]]
            audio_s = [sum(c.size for c in r[0]) / engine.sample_rate
                       for r in runs[tail]]
            rtf[tail] = [r[2] / a for r, a in zip(runs[tail], audio_s)]
            row[key] = {"first_chunk_ms": spread(firsts[tail]),
                        "rtf": spread(rtf[tail]),
                        "audio_s": spread(audio_s)}
        # per text: how much the stacked tail cuts RTF, and how much longer
        # it makes the listener wait for the first chunk
        row["rtf_per_chunk_over_batched"] = spread(
            [b / a for a, b in zip(rtf[True], rtf[False])])
        row["first_chunk_batched_over_per_chunk"] = spread(
            [a / b for a, b in zip(firsts[True], firsts[False])])
        # the decode of one chunk and of a full tail stack, on the device
        # (one call behind each sleep: a B = 1 int8 decode takes the host
        # some 5 ms to queue, too long for several behind one sleep)
        z = torch.randn(CHUNK_BATCHES[-1], DEFAULT_BLOCK + 2 * DEFAULT_PAD,
                        m.inter_channels, device="cuda")
        g = model._speaker(torch.ones(CHUNK_BATCHES[-1], dtype=torch.long,
                                      device="cuda"))
        with torch.inference_mode():
            for b in CHUNK_BATCHES:
                row[f"decode_B{b}_device_ms"] = min(device_ms(
                    lambda: model.decode(z[:b], g[:b], precision=name), 1)
                    for _ in range(3))
                row[f"decode_B{b}_ms"] = cuda_ms(
                    lambda: model.decode(z[:b], g[:b], precision=name), 5)
        print("streaming " + json.dumps(row))
        out[name] = row
        if name == "f32":
            streamed = [sum(c.size for c in r[0]) for r in runs[True]]
    engine = engines["f32"]
    engine.stream_batch_tail = True
    # /stream: 3 requests of the texts streamed above
    server = TtsServer(engine, host="127.0.0.1", port=0)
    server.start_background()
    try:
        firsts = []
        for k in range(3):
            pcm, first = read_stream(server.port, texts[k % len(texts)])
            want = streamed[k % len(texts)]
            check(pcm.size == want, f"/stream sent {2 * pcm.size} bytes for "
                                    f"{want} samples")
            firsts.append(first)
    finally:
        server.shutdown()
    # a burst on `/` through the batcher, at scales (0, 1, 0)
    engine.scales = (0.0, 1.0, 0.0)
    server = TtsServer(engine, host="127.0.0.1", port=0, batching=True,
                       max_delay_s=0.05)
    server.start_background()
    burst = [stream_text(rng, hanzi, 1) for _ in range(8)]
    try:
        with concurrent.futures.ThreadPoolExecutor(len(burst)) as pool:
            t0 = time.perf_counter()
            answers = list(pool.map(lambda t: http_wav(server.port, t),
                                    burst))
            burst_s = time.perf_counter() - t0
    finally:
        server.shutdown()
    worst = 0
    for text, pcm in zip(burst, answers):
        want = (np.clip(engine.synthesize(text, "spk1"), -1, 1)
                * 32767.0).astype(np.int16)
        check(pcm.shape == want.shape, f"burst: {pcm.shape} vs {want.shape}")
        worst = max(worst, int(np.abs(pcm.astype(np.int32) - want).max()))
    # 2e-4 of full scale, plus the rounding to int16
    check(worst <= 8, f"burst: batched audio differs from the unbatched "
                      f"engine's by {worst} / 32767")
    # the requests shared engine calls: the comparison above is the batched
    # path against the unbatched one, not the unbatched one against itself
    sizes = server.batcher.batch_sizes
    check(max(sizes) >= 2, f"burst: no batch held two requests: {sizes}")
    out["http"] = {"card": card, "stream_requests": len(firsts),
                   "stream_first_chunk_ms": firsts,
                   "burst_requests": len(burst), "burst_s": burst_s,
                   "burst_batch_sizes": sizes,
                   "burst_max_abs_int16": worst}
    print("streaming_http " + json.dumps(out["http"]))
    return out


@contextlib.contextmanager
def cpu_drawn_noise(seed: int):
    """Every normal draw of the port made on the CPU from `seed` and moved
    to its device, so that a GPU run and a CPU run of a path that draws
    (the posterior sample of voice conversion) see the same noise."""
    from wetts_tpu_torch.ops import random as port_random

    real = port_random.normal

    def normal(shape, device, dtype=torch.float32, generator=None):
        gen = torch.Generator().manual_seed(seed)
        return torch.randn(tuple(shape), generator=gen,
                           dtype=dtype).to(device)

    port_random.normal = normal
    try:
        yield
    finally:
        port_random.normal = real


def within(got, want, what: str) -> dict:
    """got (GPU) against want (CPU), float arrays of equal shapes, within
    2e-4 * max(1, max|want|): the f32 parity bound, scaled where the wave
    is large."""
    check(len(got) == len(want) and all(
        np.shape(g) == np.shape(w) for g, w in zip(got, want)),
        f"{what}: shapes differ")
    check(all(np.isfinite(g).all() for g in got), f"{what}: not finite")
    peak = max(float(np.abs(w).max()) for w in want)
    err = max(float(np.abs(np.asarray(g) - w).max())
              for g, w in zip(got, want))
    tol = 2e-4 * max(1.0, peak)
    check(err <= tol, f"{what}: max abs diff {err} > {tol}")
    return {"max_abs_err": err, "max_abs_want": peak, "tolerance": tol}


# VB at the batch cell's most common decode: 8 rows of 1152 latent frames,
# the backbone over 1153
VOCOS_ROWS, VOCOS_FRAMES = 8, 1152
# largest gap over the largest magnitude against float64: a GEMM's (of its
# product's part, for pw_conv2 the update scale * (acc + bias)), which a
# single TF32 pass fails by a hundredfold (it reads 2-4e-4; VB's GEMMs some
# 5e-7, and 1.1-1.3e-5 at pw_conv2 with all of K summed on the tensor
# cores), and a row launch's (VB reads 1.2-1.9e-7)
VOCOS_GEMM_TOL, VOCOS_ROW_TOL = 2e-6, 1e-6


@torch.inference_mode()
def phase_vocos_kernels() -> dict:
    """VB's two kernels (`csrc/vocos_backbone.cu` through
    `models/vocos_backbone.py`) against float64 at VOCOS_ROWS x
    VOCOS_FRAMES, the published widths with seeded random weights
    (`tools/probe_vocos.random_decoder`), f32 with TF32 off:
    - each of the backbone's 18 GEMMs (`vocos_gemm`), in its epilogue mode
      on the activations the module path gives it: within VOCOS_GEMM_TOL,
      which the same product in a single TF32 pass (cuBLAS, TF32 on) must
      fail, and under a twentieth of that pass's gap;
    - each of its 10 row launches (`vocos_rownorm`: the depthwise conv and
      LayerNorm, or LayerNorm alone) within VOCOS_ROW_TOL;
    - timed in turns (kernels, plain, library, kernels): the 18 GEMM
      launches of one backbone against their plain versions (F.linear and
      the epilogue's ops) and the module path's cuDNN 1x1 convs alone
      (F.conv1d on [B, C, T]); the 10 row launches against the module
      path's (the depthwise conv and LayerNorm modules, with their
      transposes) and F.layer_norm alone; bounds from these inputs (the
      GEMMs' 3 TF32 products per f32 product at 495 TFLOP/s, or their
      bytes; the row launches' bytes).
    Returns {"gemm": row, "rownorm": row}."""
    import torch.nn.functional as F

    from wetts_tpu_torch.models import vocos_backbone as vb
    from wetts_tpu_torch.tools.probe_vocos import WIDTHS, random_decoder

    dec = random_decoder()
    rows, t1 = VOCOS_ROWS, VOCOS_FRAMES + 1
    m = rows * t1
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    z = torch.randn(rows, VOCOS_FRAMES, WIDTHS["in_channels"], device="cuda",
                    generator=gen)
    g = torch.randn(rows, WIDTHS["gin_channels"], 1, device="cuda",
                    generator=gen)
    packed = dec.packed_weights()
    cond = dec.cond(g)[:, :, 0].contiguous()

    def linear(x, conv):
        return F.linear(x, conv.weight[:, :, 0], conv.bias)

    def channels_first(x):
        return x.view(rows, t1, -1).transpose(1, 2)

    def channels_last(x):
        return x.transpose(1, 2).reshape(m, -1).contiguous()

    # the module path's activations, channels last: each GEMM's (name,
    # conv, packed, input, mode, aux, residual) and each row launch's
    # (input, norm, dw_conv)
    gemms, norms = [], []
    x = torch.cat([z[:, 1:2], z], dim=1).reshape(m, -1)
    gemms.append(("in_conv", dec.in_conv, packed[0], x, vb.BIAS, cond, None))
    x = linear(x, dec.in_conv) + cond.repeat_interleave(t1, dim=0)
    norms.append((x, dec.norm_pre, None))
    x = channels_last(dec.norm_pre(channels_first(x)))
    for i, layer in enumerate(dec.layers):
        norms.append((x, layer.norm, layer.dw_conv))
        y = channels_last(layer.norm(layer.dw_conv(channels_first(x))))
        gemms.append(("pw_conv1", layer.pw_conv1, packed[1 + 2 * i], y,
                      vb.GELU, None, None))
        h = F.gelu(linear(y, layer.pw_conv1))
        gemms.append(("pw_conv2", layer.pw_conv2, packed[2 + 2 * i], h,
                      vb.RESIDUAL, layer.scale, x))
        x = x + layer.scale * linear(h, layer.pw_conv2)
    norms.append((x, dec.norm_post, None))
    y = channels_last(dec.norm_post(channels_first(x)))
    gemms.append(("out_conv", dec.out_conv, packed[-1], y, vb.BIAS, None,
                  None))

    def part(conv, x, mode, aux, tf32=False):
        """The GEMM's part of its output in float64, or (tf32) with the
        product by cuBLAS in a single TF32 pass: acc + bias (+ the row
        vector), its GELU, or pw_conv2's update scale * (acc + bias)."""
        if tf32:
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                v = linear(x, conv).double()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        else:
            v = F.linear(x.double(), conv.weight[:, :, 0].double(),
                         conv.bias.double())
        if mode == vb.GELU:
            return F.gelu(v)
        if mode == vb.RESIDUAL:
            return aux.double() * v
        return v if aux is None else v + aux.double().repeat_interleave(
            t1, dim=0)

    def gap(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    gemm_rows = []
    for name, conv, pk, x, mode, aux, res in gemms:
        w = conv.weight[:, :, 0]
        # pw_conv2's update alone on a zero residual: on its own residual
        # the output's rounding would hide the update's gap
        out = None if res is None else torch.zeros_like(res)
        got = vb.gemm(x, w, pk, conv.bias, mode, aux, t1, out)
        want = part(conv, x, mode, aux)
        row = {"name": name, "M": m, "N": w.shape[0], "K": w.shape[1],
               "max_abs_err": (got.double() - want).abs().max().item(),
               "gap": gap(got.double(), want),
               "gap_tf32": gap(part(conv, x, mode, aux, tf32=True), want)}
        if res is not None:
            # on its residual, in place: residual + update within two
            # roundings of the output
            on_res = vb.gemm(x, w, pk, conv.bias, mode, aux, t1, res.clone())
            row["residual_ulps"] = ((on_res.double() - res.double()
                                     - got.double()).abs().max()
                                    / (2.0 ** -23 * res.abs().max())).item()
        gemm_rows.append(row)
    norm_rows = []
    for x, norm, dw in norms:
        xd = x.double()
        if dw is not None:
            xd = channels_last(F.conv1d(
                channels_first(xd), dw.weight.double(), dw.bias.double(),
                padding=1, groups=x.shape[1]))
        want = F.layer_norm(xd, (x.shape[1],), norm.gamma.double(),
                            norm.beta.double(), vb.LN_EPS)
        got = vb.rownorm(x, t1, norm, dw).double()
        norm_rows.append({"conv": dw is not None,
                          "max_abs_err": (got - want).abs().max().item(),
                          "gap": gap(got, want)})

    # timed; pw_conv2's residuals written in place on copies
    outs = [None if res is None else res.clone() for *_, res in gemms]
    gemms_cf = [channels_first(x).contiguous() for _, _, _, x, *_ in gemms]
    norms_cf = [channels_first(x).contiguous() for x, _, _ in norms]

    def kernel_gemms():
        for (_, conv, pk, x, mode, aux, _), out in zip(gemms, outs):
            vb.gemm(x, conv.weight[:, :, 0], pk, conv.bias, mode, aux, t1,
                    out)

    def plain_gemms():
        for _, conv, _, x, mode, aux, res in gemms:
            v = linear(x, conv)
            if mode == vb.GELU:
                F.gelu(v)
            elif mode == vb.RESIDUAL:
                res + aux * v
            elif aux is not None:
                v + aux.repeat_interleave(t1, dim=0)

    def library_gemms():
        for (_, conv, *_), x in zip(gemms, gemms_cf):
            F.conv1d(x, conv.weight, conv.bias)

    def kernel_norms():
        for x, norm, dw in norms:
            vb.rownorm(x, t1, norm, dw)

    def module_norms():
        for (_, norm, dw), x in zip(norms, norms_cf):
            norm(x if dw is None else dw(x))

    def library_norms():
        for x, norm, _ in norms:
            F.layer_norm(x, (x.shape[1],), norm.gamma, norm.beta, vb.LN_EPS)

    def timed(kernel, plain, library, reps):
        """in turns: kernel, plain, library, kernel."""
        ms = device_ms(kernel, reps)
        plain_ms, library_ms = device_ms(plain, 5), device_ms(library, 5)
        return 0.5 * (ms + device_ms(kernel, reps)), plain_ms, library_ms

    flops = sum(2 * r["M"] * r["N"] * r["K"] for r in gemm_rows)
    # activations in and out (pw_conv2's residual in too), packed weights
    gemm_bytes = sum(
        4 * (x.numel() + (1 if res is None else 2) * m * conv.weight.shape[0]
             + pk.numel()) for _, conv, pk, x, _, _, res in gemms)
    ms, plain_ms, library_ms = timed(kernel_gemms, plain_gemms,
                                     library_gemms, 10)
    gemm = {"rows": rows, "frames": t1, "launches": len(gemm_rows),
            "gemms": gemm_rows,
            "max_abs_err": max(r["max_abs_err"] for r in gemm_rows),
            "gap": max(r["gap"] for r in gemm_rows),
            "gap_tf32_min": min(r["gap_tf32"] for r in gemm_rows),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": 1e3 * max(3 * flops / PEAK_TF32_FLOPS,
                                  gemm_bytes / PEAK_BYTES),
            "gflop": flops / 1e9, "tflops": flops / ms / 1e9}
    ms, plain_ms, library_ms = timed(kernel_norms, module_norms,
                                     library_norms, 20)
    rownorm = {"rows": rows, "frames": t1, "launches": len(norm_rows),
               "norms": norm_rows,
               "max_abs_err": max(r["max_abs_err"] for r in norm_rows),
               "gap": max(r["gap"] for r in norm_rows),
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": 1e3 * sum(8 * x.numel() for x, _, _ in norms)
               / PEAK_BYTES}
    print("VB gemm " + json.dumps(gemm))
    print("VB rownorm " + json.dumps(rownorm))
    for r in gemm_rows:
        what = f"VB {r['name']} [{r['M']}, {r['N']}, {r['K']}]"
        check(r["gap"] <= VOCOS_GEMM_TOL,
              f"{what}: gap {r['gap']} > {VOCOS_GEMM_TOL}")
        check(r["gap_tf32"] > VOCOS_GEMM_TOL,
              f"{what}: a single TF32 pass's gap {r['gap_tf32']} is within "
              f"{VOCOS_GEMM_TOL}, so the tolerance tells nothing")
        check(r["gap"] < r["gap_tf32"] / 20,
              f"{what}: gap {r['gap']}, a single TF32 pass's "
              f"{r['gap_tf32']}")
        check(r.get("residual_ulps", 0) <= 2,
              f"{what}: the residual added {r.get('residual_ulps')} ulps "
              f"off")
    for r in norm_rows:
        check(r["gap"] <= VOCOS_ROW_TOL,
              f"VB rownorm (conv {r['conv']}): gap {r['gap']} > "
              f"{VOCOS_ROW_TOL}")
    return {"gemm": gemm, "rownorm": rownorm}


def phase_vits2(card: str, v1_stages: dict, fe) -> dict:
    """VITS2 serving at the full width and depth of vits2_vocos_v1.json
    (24 kHz; `pre_conv` transformer flows; the Vocos decoder, 512 / 1536 /
    1026 channels, 8 ConvNeXt layers, an iSTFT of n_fft 1024 / hop 256),
    seeded random weights, the phone table of the frontend (the raw-phone
    requests use its first 64 ids), 4 speakers:
    - one batch of 4 requests at scales (0, 1, 0), the GPU engine against
      the port's CPU engine within 2e-4 * max(1, max|cpu|);
    - VITS2_BATCHES batches of 4 raw-phone requests of about 4 s (the
      length_scale calibrated on the first batch) at the default noise
      scales: audio-s/s, batch p50 ms, StageTimes encode / flow / decode;
      every decode on VB (`vocos_fused`), its launches zeroed just before
      the batches and read just after: 18 GEMM and 10 row launches a
      decode;
    - device ms of encode_prior, flow_reverse and decode at B = 4 and the
      352-frame bucket, beside v1's (`phase_model_stages`);
    - voice conversion of one of those requests from speaker 0 to speaker
      1: ms, and the GPU against the CPU with the same noise, same bound;
    - VITS2_STREAMS texts of VITS2_STREAM_CLAUSES clauses of about 4 s
      through the frontend on both streaming paths at scales (0, s, 0):
      the batched tail equal to per-chunk decode within 2e-4 * max(1,
      max|chunk|), each clause's chunks summing to y_len * hop; first-chunk
      ms and stream RTF;
    - one `/stream` request and three `/` requests through TtsServer, the
      WAVs at 24000 Hz;
    - vits2_v1.json (the same flows, the HiFi-GAN decoder, 22.05 kHz), one
      batch under f32, `half` and `quantize`: K1 and Q0-Q2 launched per
      decode as on v1 and no VB launch, the reduced audio held to f32 with
      v1's bounds.
    Returns the vits2_v1 engines' kernel launches per precision, and VB's
    of the batches under "vits2_vocos"."""
    from wetts_tpu_torch.models import vocos_backbone as vb
    from wetts_tpu_torch.serving.engine import MAX_CLAUSE_LEN, SynthesisEngine
    from wetts_tpu_torch.serving.server import TtsServer
    from wetts_tpu_torch.serving.streaming import DEFAULT_BLOCK
    from wetts_tpu_torch.text.segmenter import sentence_segment
    from wetts_tpu_torch.train.step import compute_spec

    frontend, _, phone2id, hanzi, _ = fe
    cfg = vits2_config(VITS2_CONFIG, len(phone2id))
    engine = build_engine(cfg)
    model = engine.model
    check(engine.sample_rate == 24000 and engine.hop == 256,
          f"vits2: {engine.sample_rate} Hz, hop {engine.hop}")
    rng = np.random.default_rng(SEED)
    out = {"card": card, "config": os.path.basename(VITS2_CONFIG)}

    # the GPU engine against the CPU engine at scales (0, 1, 0)
    ids, sids = utterance_batches(engine, rng, 1)[0]
    cpu_engine = SynthesisEngine(
        cfg, copy.deepcopy(model).cpu(), engine.phone2id, engine.speaker2id,
        device="cpu", noise_scale=0.0, noise_scale_w=0.0)
    engine.scales = (0.0, 1.0, 0.0)
    want = cpu_engine.synthesize_ids_batch(ids, sids)
    out["reference"] = within(engine.synthesize_ids_batch(ids, sids), want,
                              "vits2 GPU vs CPU engine")
    out["reference"]["samples"] = [w.size for w in want]

    # batched synthesis, requests of about 4 s
    def frames_at(length_scale):
        engine.scales = (0.0, length_scale, 0.0)
        return float(engine._encode_flow(ids, sids)[1].float().mean())

    length_scale = length_scale_for(
        frames_at, 4.0 * engine.sample_rate / engine.hop, "vits2 requests")
    engine.scales = (0.667, length_scale, 0.8)
    for b_ids, b_sids in utterance_batches(engine, rng, 2):  # warm-up
        engine.synthesize_ids_batch(b_ids, b_sids)
    batches = utterance_batches(engine, rng, VITS2_BATCHES)
    engine.stage_times.reset()
    vb.gemm.launches = vb.rownorm.launches = 0
    audios, synth = phase_synthesis(engine, batches)
    vocos = {"vocos_gemm": vb.gemm.launches,
             "vocos_rownorm": vb.rownorm.launches}
    report = engine.stage_times.report()
    # every decode on VB: 2 GEMMs and a row launch a ConvNeXt layer, the
    # in_conv and out_conv, norm_pre and norm_post
    fused, layers = report["vocos_fused"], cfg.model.vocos_num_layers
    check(fused["count"] == fused["n"] == report["decode"]["n"] > 0,
          f"vits2: {fused['count']} of {fused['n']} Vocos decodes on VB, "
          f"{report['decode']['n']} decodes")
    check(vocos == {"vocos_gemm": (2 * layers + 2) * fused["count"],
                    "vocos_rownorm": (layers + 2) * fused["count"]},
          f"vits2: VB launched {vocos} for {fused['count']} decodes")
    synth["vocos_launches"] = dict(vocos, decodes=fused["count"])
    synth.update(length_scale=length_scale, stage_ms_p50={
        k: report[k]["p50_ms"] for k in ("encode", "flow", "decode")})
    out["synthesis"] = synth
    out["model_stages"] = {
        "vits2_vocos_v1": phase_model_stages(model, {"f32": None}),
        "v1": v1_stages}

    # voice conversion of one request, speaker 0 -> 1
    wav = torch.from_numpy(audios[0])[None].cuda()
    with torch.inference_mode():
        spec = compute_spec(cfg, wav)
        args = (spec, torch.tensor([spec.shape[1]], device="cuda"),
                torch.tensor([0], device="cuda"),
                torch.tensor([1], device="cuda"))
        gen = torch.Generator("cuda").manual_seed(SEED)
        vc_ms = cuda_ms(lambda: model.voice_conversion(*args,
                                                       generator=gen), 5)
        with cpu_drawn_noise(SEED):
            got = model.voice_conversion(*args)[0].cpu().numpy()
            want = cpu_engine.model.voice_conversion(
                *(a.cpu() for a in args))[0].numpy()
    check(got.shape == (1, wav.shape[1], 1), f"vc shape {got.shape}")
    out["voice_conversion"] = {"audio_s": wav.shape[1] / engine.sample_rate,
                               "ms": vc_ms,
                               **within([got], [want], "vits2 vc")}

    # streaming through the frontend, both paths
    s_engine = SynthesisEngine(cfg, model, phone2id, engine.speaker2id,
                               frontend=frontend, seed=SEED,
                               noise_scale=0.0, noise_scale_w=0.0)
    hop = s_engine.hop
    calibration = sentence_segment(stream_text(rng, hanzi, 4), MAX_CLAUSE_LEN)
    stream_scale = length_scale_for(
        lambda ls: float(np.mean([f for f, _ in clause_frames(
            s_engine, calibration, ls)])),
        STREAM_CLAUSE_S * s_engine.sample_rate / hop, "vits2 clauses")
    texts = [stream_text(rng, hanzi, VITS2_STREAM_CLAUSES)
             for _ in range(VITS2_STREAMS)]
    frames = {t: clause_frames(s_engine, sentence_segment(t, MAX_CLAUSE_LEN),
                               stream_scale) for t in texts}
    check(all(f < clip for v in frames.values() for f, clip in v),
          "vits2: a streamed clause reaches its bucket's max_frames clip")
    runs = {True: [], False: []}
    for tail in (True, False):  # warm-up
        s_engine.stream_batch_tail = tail
        list(s_engine.stream_synthesize(stream_text(rng, hanzi, 2), "spk1"))
    for text in texts:
        for tail in (True, False):
            s_engine.stream_batch_tail = tail
            chunks, first = [], None
            t0 = time.perf_counter()
            for chunk in s_engine.stream_synthesize(text, "spk1"):
                if first is None:
                    first = 1e3 * (time.perf_counter() - t0)
                chunks.append(chunk)
            runs[tail].append((chunks, first, time.perf_counter() - t0))
    for text, (batched, _, _), (per_chunk, _, _) in zip(
            texts, runs[True], runs[False]):
        lo = 0
        for y_len, _ in frames[text]:
            n = math.ceil(y_len / DEFAULT_BLOCK)
            got = sum(c.size for c in batched[lo: lo + n])
            check(got == y_len * hop, f"vits2 stream: a clause of {y_len} "
                                      f"frames streamed {got} samples")
            lo += n
        check(lo == len(batched), f"vits2 stream: {len(batched)} chunks, "
                                  f"{lo} from the clauses' lengths")
    stream = within([c for r in runs[True] for c in r[0]],
                    [c for r in runs[False] for c in r[0]],
                    "vits2 stream, batched tail vs per chunk")
    stream.update(streams=len(texts), clauses_per_stream=VITS2_STREAM_CLAUSES,
                  length_scale=stream_scale,
                  chunks_per_stream=[len(r[0]) for r in runs[True]])
    for tail, key in ((True, "batched_tail"), (False, "per_chunk")):
        audio_s = [sum(c.size for c in r[0]) / s_engine.sample_rate
                   for r in runs[tail]]
        stream[key] = {
            "first_chunk_ms": spread([r[1] for r in runs[tail]]),
            "rtf": spread([r[2] / a for r, a in zip(runs[tail], audio_s)]),
            "audio_s": spread(audio_s)}
    out["streaming"] = stream

    # HTTP: /stream on the frontend engine, / on the raw-phone one
    s_engine.stream_batch_tail = True
    server = TtsServer(s_engine, host="127.0.0.1", port=0)
    server.start_background()
    try:
        pcm, first = read_stream(server.port, texts[0])
    finally:
        server.shutdown()
    streamed = sum(c.size for c in runs[True][0][0])
    check(pcm.size == streamed, f"vits2 /stream sent {pcm.size} samples, "
                                f"not {streamed}")
    phase_serving(engine, rng)
    out["http"] = {"stream_first_chunk_ms": first, "wav_rate": 24000}
    del engine, cpu_engine, s_engine, model
    torch.cuda.empty_cache()

    # vits2_v1.json under each precision: one batch, launches counted
    cfg1 = vits2_config(VITS2_HIFIGAN_CONFIG, N_PHONES)
    counters = kernel_counters()
    launches, results = {}, {}
    for name in ("f32", "bf16", "int8"):
        e = build_engine(cfg1, precision=name)
        e.synthesize(phrase(np.random.default_rng(SEED), 10))  # warm-up
        batch = utterance_batches(e, np.random.default_rng(SEED + 1), 1)[0]
        for fn in (*counters.values(), vb.gemm, vb.rownorm):
            fn.launches = 0
        e.stage_times.reset()
        results[name] = e.synthesize_ids_batch(*batch)
        launches[name] = {k: fn.launches for k, fn in counters.items()}
        check(vb.gemm.launches == vb.rownorm.launches == 0,
              f"vits2_v1 {name}: the HiFi-GAN decoder launched VB")
        check_launches(f"vits2_v1 {name}", launches[name], cfg1.model, name,
                       e.stage_times.report()["decode"]["n"])
        del e
    out["vits2_v1"] = {
        "launches": launches,
        "bf16": compare_with_f32("vits2_v1 bf16", results["bf16"],
                                 results["f32"], 0.995),
        "int8": compare_with_f32("vits2_v1 int8", results["int8"],
                                 results["f32"], 0.99)}
    torch.cuda.empty_cache()
    print("vits2 " + json.dumps(out))
    return dict(launches, vits2_vocos=vocos)


# the bundle phase: G_<step>.pth -> export_bundle -> Model at each precision
# 256 requests of about 25 ms: a timed window of some 6 s a precision
BUNDLE_STEP, BUNDLE_REQUESTS = 90000, 256
# length_scale 5 (phase 5's) folded into the weights, since a Model serves
# at the fixed scales (0.667, 1, 0.8): the stochastic duration predictor's
# last affine shifted by log 5 in the log-duration domain
BUNDLE_LOG_DURATION_SHIFT = math.log(5.0)


def run_module(*args: str) -> str:
    """`python -m <args>` from the checkout's root; its standard output."""
    proc = subprocess.run(
        [sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    check(proc.returncode == 0, f"python -m {args[0]} exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout


def write_tables(d: str, phone2id: dict, cfg_path: str) -> None:
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "phones.txt"), "w", encoding="utf8") as f:
        f.writelines(f"{p} {i}\n" for p, i in phone2id.items())
    with open(os.path.join(d, "speaker.txt"), "w") as f:
        f.writelines(f"spk{i} {i}\n" for i in range(N_SPEAKERS))
    with open(cfg_path) as src, open(os.path.join(d, "config.json"),
                                     "w") as dst:
        dst.write(src.read())


def write_frontend_bundle(d: str, vocab: dict, pinyin2id: dict) -> None:
    """frontend/ in the JAX export's layout (config.json + params.npz), of
    a random bert-base-chinese-wide FrontendModel (build_frontend's, on the
    CPU) written through convert_frontend_torch and save_params_npz, with
    the vocabulary of frontend_tables(); the lexicon tables come from the
    vendored assets."""
    import dataclasses

    from wetts_tpu_torch.models.bert_frontend import (
        BertConfig,
        FrontendModel,
        convert_frontend_torch,
    )
    from wetts_tpu_torch.utils.params_io import save_params_npz

    torch.manual_seed(SEED)
    bert = BertConfig()
    fm = FrontendModel(len(pinyin2id), 5, bert)
    params, meta = convert_frontend_torch(
        {k: v.numpy() for k, v in fm.state_dict().items()})
    os.makedirs(d)
    save_params_npz(os.path.join(d, "params.npz"), params)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"bert": dataclasses.asdict(bert),
                   "num_polyphones": len(pinyin2id), "num_prosody": 5,
                   "transform_heads": meta["transform_heads"],
                   "transform_ffn": meta["transform_ffn"]}, f)
    with open(os.path.join(d, "vocab.txt"), "w", encoding="utf8") as f:
        f.writelines(t + "\n" for t in sorted(vocab, key=vocab.get))


class Recorder:
    """Wraps an engine's `synthesize` and keeps each float wave it gave."""

    def __init__(self, fn):
        self.fn, self.waves = fn, []

    def __call__(self, *args):
        out = self.fn(*args)
        self.waves.append(out)
        return out


class ShapeRecorder:
    """Wraps an engine's `_frame_bucket` and keeps each (text bucket's
    frame cap, decode frames) shape it chose."""

    def __init__(self, fn):
        self.fn, self.shapes = fn, []

    def __call__(self, max_len, cap):
        out = self.fn(max_len, cap)
        self.shapes.append((cap, out))
        return out


def serve_bundle(bundle: str, precision: str, texts) -> dict:
    """Model(bundle, precision) on the card: its load time; `texts` one
    request at a time, untimed, to warm every (text bucket, decode frames)
    shape the timed pass will meet; then `texts` again, one request at a
    time and each timed, every kernel's count zeroed just before and read
    just after (one decode a request). A shape of the timed pass that the
    warm-up never met is counted, not hidden."""
    from wetts_tpu_torch.cli.model import Model

    counters = kernel_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = Model(bundle, precision=precision)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(m.engine.precision == precision and m.engine.frontend is not None
          and m.engine.device == torch.device("cuda"),
          f"bundle Model {precision}: {m.engine.precision} on "
          f"{m.engine.device}")
    m.engine.synthesize = Recorder(m.engine.synthesize)
    m.engine._frame_bucket = ShapeRecorder(m.engine._frame_bucket)

    def run():
        for fn in counters.values():
            fn.launches = 0
        m.engine.stage_times.reset()
        audio, ms = [], []
        t_all = time.perf_counter()
        for text in texts:
            t0 = time.perf_counter()
            audio.append(m.synthesis(text, "spk1"))
            ms.append(1e3 * (time.perf_counter() - t0))
        return audio, ms, time.perf_counter() - t_all

    warm_audio, warm_ms, _ = run()
    warm_shapes = set(m.engine._frame_bucket.shapes)
    m.engine._frame_bucket.shapes = []
    audio, ms, wall = run()
    launches = {k: fn.launches for k, fn in counters.items()}
    n_decode = m.engine.stage_times.report()["decode"]["n"]
    check(n_decode == len(texts), f"{n_decode} decodes for {len(texts)} "
          "one-sentence requests")
    check_launches(f"bundle {precision}", launches, m.engine.cfg.model,
                   precision, n_decode)
    for text, a in zip(texts, audio):
        check(a.dtype == np.int16 and a.size > 0 and a.size % m.engine.hop
              == 0 and int(np.abs(a.astype(np.int32)).max()) > 1000,
              f"bundle {precision}: int16 audio {a.dtype} {a.shape}")
        clip = m.engine._bucket(len(m.engine.text_to_phone_ids(text)))[1]
        check(a.size // m.engine.hop < clip, f"bundle {precision}: a "
              f"request reaches its text bucket's {clip}-frame clip")
    shapes = set(m.engine._frame_bucket.shapes)
    seconds = sum(a.size for a in audio) / m.sample_rate
    return {"model": m, "warm_audio": warm_audio, "audio": audio,
            "waves": m.engine.synthesize.waves[len(texts):],
            "report": {"load_s": load_s, "requests": len(texts),
                       "mean_request_audio_s": seconds / len(texts),
                       "request_ms": spread(ms),
                       "audio_s_per_s": seconds / wall,
                       "window_s": wall,
                       "warmup_request_ms": spread(warm_ms),
                       "shapes": len(shapes),
                       "shapes_not_warmed": len(shapes - warm_shapes),
                       "launches": launches}}


def int16_max_diff(got, want) -> int:
    check(len(got) == len(want) and all(g.shape == w.shape
                                        for g, w in zip(got, want)),
          "int16 audio of unequal shapes")
    return max(int(np.abs(g.astype(np.int32) - w.astype(np.int32)).max())
               for g, w in zip(got, want))


def phase_bundle(cfg, model) -> dict:
    """The model bundle on the card (phase 5b). Phase 5's f32 synthesizer
    (v1.json at full width, durations scaled by 5 in its weights) is saved
    as a released training dir (`G_90000.pth` with a `D_90000.pth` that
    must be ignored, v1.json as it stands, the frontend's phone table on
    the model's 64 ids, 4 speakers), exported by `bin/export_bundle` as a
    subprocess (plain and with --fold_weight_norm), given a `frontend/` in
    the config.json + params.npz layout, and served through
    `cli.model.Model` at f32, bf16 and int8: BUNDLE_REQUESTS Mandarin
    sentences of STREAM_HANZI hanzi (about 4 s each), one request at a
    time, each once untimed to warm its shapes and then once timed
    (serve_bundle). Checks: the f32 bundle's int16 audio of both passes
    equals a SynthesisEngine on the in-memory model with the same seed and
    frontend within 1 LSB, the folded bundle's within the f32 parity bound
    (2e-4 on the float wave; 2 * 2e-4 * 0.6 * 32767 / peak + 1 LSB); bf16
    and int8 against f32 with phase 5's bounds (compare_with_f32); K1 72
    launches a decode under f32 and bf16, Q0-Q2 only under int8
    (check_launches); the `tts` CLI, a fresh process on the card, writes
    the f32 Model's first request's audio at v1's rate within 1 LSB (the
    CLI's `Model` turns cuDNN's TF32 off, as this script does);
    `bin/eval_mcd` gives 0.0 for the f32 WAV against itself, and the
    bf16 and int8 MCDs are printed (figures, not a gate: random weights);
    a vits2_vocos_v1.json bundle asked for bf16 logs the warning and
    serves the f32 Model's audio. One `bundle` line, with the phase's
    wall seconds."""
    import logging

    from wetts_tpu_torch.cli.model import Model
    from wetts_tpu_torch.serving.engine import SynthesisEngine
    from wetts_tpu_torch.utils.wav import read_wav, write_wav

    t_phase = time.perf_counter()
    check(cfg.model.use_sdp, "the duration shift needs the SDP")
    model = copy.deepcopy(model).eval()
    with torch.no_grad():
        p = dict(model.named_parameters())
        p["dp.flows.0.m"][0] -= (BUNDLE_LOG_DURATION_SHIFT
                                 * torch.exp(p["dp.flows.0.logs"][0]))
    vocab, lexicon, pinyin2id, _, _, phones = frontend_tables()
    # the frontend's phones (sil first) on the model's N_PHONES ids
    phone2id = {ph: i % N_PHONES for i, ph in enumerate(phones)}
    hanzi = [w for w in lexicon.words() if len(w) == 1]
    rng = np.random.default_rng(SEED)
    texts = [stream_text(rng, hanzi, 1) for _ in range(BUNDLE_REQUESTS)]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exp = os.path.join(tmp, "exp")
        write_tables(exp, phone2id, CONFIG)
        sd = {k: v.cpu() for k, v in model.state_dict().items()}
        torch.save({"model": sd, "iteration": BUNDLE_STEP},
                   os.path.join(exp, f"G_{BUNDLE_STEP}.pth"))
        torch.save({"model": {}, "iteration": BUNDLE_STEP},
                   os.path.join(exp, f"D_{BUNDLE_STEP}.pth"))
        bundle, folded = (os.path.join(tmp, "bundle"),
                          os.path.join(tmp, "folded"))
        t0 = time.perf_counter()
        for out_dir, extra in ((bundle, ()), (folded, ("--fold_weight_norm",))):
            run_module("wetts_tpu_torch.bin.export_bundle",
                       "--cfg", os.path.join(exp, "config.json"),
                       "--model_dir", exp,
                       "--phone_table", os.path.join(exp, "phones.txt"),
                       "--speaker_table", os.path.join(exp, "speaker.txt"),
                       "--out_dir", out_dir, *extra)
        out["export_s"] = time.perf_counter() - t0
        check(sorted(os.listdir(bundle)) == ["config.json", "params.npz",
                                             "phones.txt", "speaker.txt"],
              f"exported bundle holds {sorted(os.listdir(bundle))}")
        write_frontend_bundle(os.path.join(bundle, "frontend"), vocab,
                              pinyin2id)
        os.symlink(os.path.join(bundle, "frontend"),
                   os.path.join(folded, "frontend"))

        served = {name: serve_bundle(bundle, name, texts)
                  for name in ("f32", "bf16", "int8")}
        f32 = served["f32"]
        # the in-memory model behind the same frontend, the same seed
        direct = SynthesisEngine(
            cfg, model, phone2id, {f"spk{i}": i for i in range(N_SPEAKERS)},
            f32["model"].engine.frontend, noise_scale=0.667,
            length_scale=1.0, noise_scale_w=0.8)

        def int16(wave):
            peak = max(0.01, float(np.abs(wave).max()))
            return (wave * 32767.0 / peak * 0.6).astype(np.int16)

        # the warm-up pass's draws, then the timed pass's
        want = [int16(direct.synthesize(t, "spk1")) for t in texts + texts]
        got = f32["warm_audio"] + f32["audio"]
        out["f32_vs_in_memory_lsb"] = int16_max_diff(got, want)
        check(out["f32_vs_in_memory_lsb"] <= 1, "the f32 bundle's audio is "
              f"{out['f32_vs_in_memory_lsb']} LSB from the in-memory model's")
        fold = serve_bundle(folded, "f32", texts)
        peak = min(max(0.01, float(np.abs(w).max())) for w in
                   f32["model"].engine.synthesize.waves)
        bound = 2 * 2e-4 * 0.6 * 32767 / peak + 1
        out["folded_vs_in_memory_lsb"] = int16_max_diff(
            fold["warm_audio"] + fold["audio"], want)
        out["folded_bound_lsb"] = bound
        check(out["folded_vs_in_memory_lsb"] <= bound,
              f"the folded bundle's audio is {out['folded_vs_in_memory_lsb']}"
              f" LSB from the in-memory model's (bound {bound})")
        out["drift"] = {
            name: compare_with_f32(f"bundle {name}", served[name]["waves"],
                                   f32["waves"], floor)
            for name, floor in (("bf16", 0.995), ("int8", 0.99))}
        out.update({name: s["report"] for name, s in served.items()})
        out["f32_folded"] = fold["report"]
        del fold, direct

        # the tts CLI, a fresh process on the card, against the first
        # request of the f32 Model above (the same draws)
        wav = os.path.join(tmp, "cli.wav")
        run_module("wetts_tpu_torch.cli.tts", "--model-dir", bundle,
                   "--text", texts[0], "--speaker", "spk1", "--wav", wav)
        got, rate = read_wav(wav)
        check(rate == cfg.data.sampling_rate, f"CLI WAV at {rate} Hz")
        got = np.round(got * 32768.0).astype(np.int16)
        out["cli_vs_in_process_lsb"] = int16_max_diff(
            [got], f32["warm_audio"][:1])
        check(out["cli_vs_in_process_lsb"] <= 1, "the tts CLI's audio is "
              f"{out['cli_vs_in_process_lsb']} LSB from the in-process "
              "Model's")

        # MCD of each precision's first request against f32's
        gen, ref_dir = os.path.join(tmp, "gen"), os.path.join(tmp, "ref")
        os.makedirs(gen)
        os.makedirs(ref_dir)
        lines = []
        for name, key in (("self", "f32"), ("bf16", "bf16"),
                          ("int8", "int8")):
            write_wav(os.path.join(gen, f"{name}.wav"),
                      served[key]["audio"][0], cfg.data.sampling_rate)
            write_wav(os.path.join(ref_dir, f"{name}.wav"),
                      f32["audio"][0], cfg.data.sampling_rate)
            lines.append(f"{ref_dir}/{name}.wav|spk1|-\n")
        with open(os.path.join(tmp, "test.txt"), "w") as f:
            f.writelines(lines)
        mcd = json.loads(run_module(
            "wetts_tpu_torch.bin.eval_mcd", "--test_file",
            os.path.join(tmp, "test.txt"),
            "--gen_dir", gen).strip().splitlines()[-1])
        out["mcd_db"] = mcd["per_pair"]
        check(mcd["n_pairs"] == 3 and mcd["per_pair"]["self"] == 0.0,
              f"MCD {mcd}")
        del served, f32
        torch.cuda.empty_cache()

        # a Vocos bundle asked for bf16: the warning, and f32's audio
        from wetts_tpu_torch.models.synthesizer import Synthesizer

        vocos = os.path.join(tmp, "vocos")
        raw = {"sil": 0, **{f"p{i}": i for i in range(1, N_PHONES)}}
        write_tables(vocos, raw, VITS2_CONFIG)
        vcfg = vits2_config(VITS2_CONFIG, N_PHONES)
        torch.save({"model": random_init_(Synthesizer(vcfg),
                                          SEED).state_dict()},
                   os.path.join(vocos, "G_1.pth"))
        caught = []
        handler = logging.Handler()
        handler.emit = caught.append
        log = logging.getLogger("wetts_tpu_torch.serving")
        log.addHandler(handler)
        try:
            half = Model(vocos, precision="bf16")
        finally:
            log.removeHandler(handler)
        check(half.engine.precision == "f32" and any(
            "serving the f32 decoder instead" in r.getMessage()
            for r in caught), "the Vocos bundle at bf16 did not warn and "
                              "serve f32")
        text = phrase(np.random.default_rng(SEED), 60)
        got = [half.synthesis(text, "spk1") for _ in range(2)]
        exact = Model(vocos)
        want = [exact.synthesis(text, "spk1") for _ in range(2)]
        check(int16_max_diff(got, want) == 0,
              "the Vocos bundle at bf16 differs from f32")
        out["vocos_bf16_served"] = half.engine.precision
    out["phase_s"] = time.perf_counter() - t_phase
    print("bundle " + json.dumps(out))
    return out


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


# ---- data parallelism, graph export, the frontend's trainer and the native
# binaries ----------------------------------------------------------------

# the data-parallel step (phase_dp): v1.json's batch of 32 at segment 8192
# on a synthetic global batch of up to DP_FRAMES frames and DP_TEXT phones;
# DP_TIMED_STEPS steps of each of the plain and the DP step at world 1, in
# alternating order
DP_FRAMES, DP_TEXT, DP_TIMED_STEPS, DP_RANKS = 400, 96, 20, 2
# graph export (phase_export): v1's 64-phone text bucket and the serving
# frame bucket; the exported and the live decoders timed in turns; the host
# time of K1's operator against its launcher, OP_HOST_REPS calls of each
# at each v1 stage in alternating order, and of OP_HOST_REPS live decodes
EXPORT_TEXT, EXPORT_REPS, OP_HOST_REPS = 64, 5, 50
# the frontend's trainer (phase_frontend_train): one epoch of four batches
# of 32 at bert-base-chinese's geometry over polyphone and prosody lines
# mixed by concatenation (two polyphone lines: two batches at least hold
# none), then FRONTEND_TIMED_STEPS more steps, timed
FRONTEND_BATCH, FRONTEND_POLY_LINES, FRONTEND_PROSODY_LINES = 32, 2, 126
FRONTEND_TIMED_STEPS = 40
# requests to the frontend bundle (phase_frontend_train) and to
# http_server_main's `/` and `/stream` (phase_native): a pass over
# SERVED_TEXTS texts warms every shape, then SERVED_REQUESTS requests of
# each kind cycle through them, each timed
SERVED_TEXTS, SERVED_REQUESTS = 8, 200


def dp_batch(cfg) -> dict:
    """A seeded global batch of cfg.train.batch_size rows on the CPU: text
    lengths from DP_TEXT / 2 to DP_TEXT, frames from 3/4 of DP_FRAMES to
    DP_FRAMES (the first row at both maxima), noise-like audio of 0.1 rms,
    zero beyond each row's frames."""
    rng = np.random.default_rng(SEED)
    b, hop = cfg.train.batch_size, cfg.data.hop_length
    text = rng.integers(DP_TEXT // 2, DP_TEXT + 1, b)
    frames = rng.integers(3 * DP_FRAMES // 4, DP_FRAMES + 1, b)
    text[0], frames[0] = DP_TEXT, DP_FRAMES
    wav = (rng.standard_normal((b, DP_FRAMES * hop)) * 0.1).astype(
        np.float32)
    wav[np.arange(DP_FRAMES * hop)[None] >= frames[:, None] * hop] = 0.0
    ids = rng.integers(1, N_PHONES, (b, DP_TEXT))
    ids[np.arange(DP_TEXT)[None] >= text[:, None]] = 0
    return {"phone_ids": torch.from_numpy(ids),
            "text_lengths": torch.from_numpy(text),
            "wav": torch.from_numpy(wav),
            "spec_lengths": torch.from_numpy(frames),
            "sid": torch.arange(b) % N_SPEAKERS}


def dp_state(cfg):
    """The seeded initial training state of `cfg` on the card."""
    from wetts_tpu_torch.train.state import GANTrainState
    from wetts_tpu_torch.train.step import build_models, init_weights_

    nets = build_models(cfg)
    init_weights_(nets[0], nets[1], torch.Generator().manual_seed(SEED),
                  *nets[2:])
    return GANTrainState.create(cfg, *(None if n is None else n.cuda()
                                       for n in nets))


def dp_step(cfg, state, batch: dict, rows=slice(None),
            plain: bool = False) -> tuple:
    """One train_step on `rows` of the global batch with the step's
    generator and torch's default one seeded alike on every rank: (float
    metrics, host ms, K2 launches). plain: the step without the DP path
    even in a process group (what `train_step` runs without one)."""
    from wetts_tpu_torch.ops.mas import maximum_path
    from wetts_tpu_torch.train import step

    feed = {k: v[rows].cuda() for k, v in batch.items()}
    torch.manual_seed(5)
    gen = torch.Generator("cuda").manual_seed(3)
    maximum_path.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if plain:
        metrics = step._step(cfg, state, feed, gen, None, None, 1,
                             lambda params: None)
    else:
        metrics = step.train_step(cfg, state, feed, gen)
    metrics = {k: float(v) for k, v in metrics.items()}
    torch.cuda.synchronize()
    return metrics, (time.perf_counter() - t0) * 1e3, maximum_path.launches


def parameters_of(state) -> dict:
    return {f"{name}.{k}": v.detach().clone()
            for name, net, _ in state.nets()
            for k, v in net.named_parameters()}


def max_param_diff(a: dict, b: dict) -> tuple:
    return max((float((a[k] - b[k]).abs().max()), k) for k in a)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_rank_main(rank: int, tmp: str, port: int) -> None:
    """One of DP_RANKS processes on the one card over gloo with CUDA
    tensors (NCCL refuses two ranks on one GPU): its rows of the global
    batch through the data-parallel step, from the same seeded state as
    every rank; rank 0 writes its parameters, each rank its metrics and K2
    launches."""
    import torch.distributed as dist

    from wetts_tpu_torch.parallel.mesh import init_distributed
    from wetts_tpu_torch.config import Config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(f"127.0.0.1:{port}", DP_RANKS, rank, "cuda:0")
    try:
        cfg = Config.from_json(CONFIG)
        cfg.num_phones, cfg.num_speakers = N_PHONES, N_SPEAKERS
        cfg.train.eps = 1e-2
        batch = torch.load(os.path.join(tmp, "batch.pt"))
        state = dp_state(cfg)
        b = cfg.train.batch_size // DP_RANKS
        rows = slice(rank * b, (rank + 1) * b)
        metrics, _, mas = dp_step(cfg, state, batch, rows)
        out = {"metrics": metrics, "mas": mas, "backend": dist.get_backend()}
        if rank == 0:
            out["params"] = {k: v.cpu() for k, v in
                             parameters_of(state).items()}
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_dp() -> dict:
    """Data parallelism (`parallel/mesh.py`) at v1.json's full width,
    batch 32, segment 8192, on a seeded synthetic global batch.
    Adam's eps is 1e-2 throughout, as in tests/test_dp_equivalence.py: at
    v1's 1e-9 the first update of a parameter whose gradient is zero in
    exact arithmetic (the attention's key biases) is +-lr by the sign of
    rounding noise, so cuDNN's nondeterminism alone moved such a parameter
    by 3.7e-4 between two runs of the same step on the card.
    1. One rank of torch.distributed on NCCL takes the step through the
       data-parallel code (shares of the global loss, the gradients
       all-reduced per net, the metrics all-reduced) from the same state as
       the step without a process group: at world 1 the two are the same
       computation, and only cuDNN's own nondeterminism may part them (its
       size is reported: max abs over the parameters, max rel over the
       metrics; the parameters held to 2e-6). Then DP_TIMED_STEPS more
       steps of each in alternating order (plain, DP, DP, plain, ...),
       host ms of each.
    2. DP_RANKS processes on the one card over gloo with CUDA tensors
       (`init_distributed` picks gloo: more processes than GPUs), each
       with batch 16, against one rank with batch 32 on the same global
       batch (tests/test_dp_equivalence.py's bounds: metrics rel 2e-4,
       parameters max abs 2e-6); K2 once on each rank. Not timed: the
       ranks share one card and the host's cores.
    One `dp` line."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from wetts_tpu_torch.config import Config
    from wetts_tpu_torch.parallel.mesh import init_distributed

    cfg = Config.from_json(CONFIG)
    cfg.num_phones, cfg.num_speakers = N_PHONES, N_SPEAKERS
    check(cfg.train.batch_size == 32 and cfg.train.segment_size == 8192,
          "v1.json's batch is no longer 32 x 8192")
    cfg.train.eps = 1e-2
    batch = dp_batch(cfg)
    out = {"batch": cfg.train.batch_size, "frames": DP_FRAMES}

    # 1. world 1 on NCCL: the data-parallel path against the plain step
    plain, dp = dp_state(cfg), dp_state(cfg)
    m_plain, _, _ = dp_step(cfg, plain, batch)
    p_plain = parameters_of(plain)
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cuda:0")
    try:
        check(dist.get_backend() == "nccl", "world 1 is not on NCCL")
        m_dp, _, mas = dp_step(cfg, dp, batch)
        p_dp = parameters_of(dp)
        times = {"plain": [], "dp": []}
        for i in range(DP_TIMED_STEPS):
            for key in (("plain", "dp") if i % 2 == 0 else ("dp", "plain")):
                times[key].append(dp_step(
                    cfg, plain if key == "plain" else dp, batch,
                    plain=key == "plain")[1])
    finally:
        dist.destroy_process_group()
    check(set(m_dp) == set(m_plain), "the DP step's metrics differ in keys")
    out["world1_param_max_abs"], where = max_param_diff(p_dp, p_plain)
    out["world1_metric_max_rel"] = max(
        abs(m_dp[k] - m_plain[k]) / max(abs(m_plain[k]), 1e-12)
        for k in m_plain)
    check(out["world1_param_max_abs"] <= 2e-6 and mas == 1,
          f"world 1 on NCCL: parameters {out['world1_param_max_abs']} "
          f"from the plain step ({where}); K2 {mas} launches")
    out["host_ms_plain"] = spread(times["plain"])
    out["host_ms_dp_world1"] = spread(times["dp"])
    # each DP step over the plain step just before or after it
    out["dp_over_plain"] = spread(np.array(times["dp"])
                                  / np.array(times["plain"]))
    del plain, dp, p_plain, p_dp
    torch.cuda.empty_cache()

    # 2. two ranks of 16 rows against one of 32
    ref = dp_state(cfg)
    m_ref, _, mas_ref = dp_step(cfg, ref, batch)
    p_ref = parameters_of(ref)
    del ref
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(batch, os.path.join(tmp, "batch.pt"))
        mp.spawn(dp_rank_main, args=(tmp, free_port()), nprocs=DP_RANKS)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(DP_RANKS)]
    m2 = ranks[0]["metrics"]
    for r in ranks[1:]:
        check(r["metrics"] == m2, "the ranks' metrics differ")
    bad = [k for k in m_ref if abs(m2[k] - m_ref[k])
           > 2e-4 * max(abs(m_ref[k]), 1.0)]
    out["two_ranks_metric_max_rel"] = max(
        abs(m2[k] - m_ref[k]) / max(abs(m_ref[k]), 1e-12) for k in m_ref)
    out["two_ranks_param_max_abs"], where = max_param_diff(
        {k: v.cuda() for k, v in ranks[0]["params"].items()}, p_ref)
    out["k2_launches_per_rank"] = [r["mas"] for r in ranks]
    check(all(r["backend"] == "gloo" for r in ranks),
          "two ranks on one card are not on gloo")
    check(not bad, f"two ranks against one: metrics {bad} beyond rel 2e-4")
    check(out["two_ranks_param_max_abs"] < 2e-6,
          f"two ranks against one: parameters "
          f"{out['two_ranks_param_max_abs']} apart at {where}")
    check(mas_ref == 1 and out["k2_launches_per_rank"] == [1] * DP_RANKS,
          f"K2 launches: {mas_ref}, {out['k2_launches_per_rank']}")
    out["mas_launches"] = mas + mas_ref + sum(out["k2_launches_per_rank"])
    print("dp " + json.dumps(out))
    return out


def phase_export(cfg, model) -> dict:
    """Graph export (`bin/export_graphs.py`) on the card. First K1's
    registered operator (`mrf_stage_op`) at each of v1's four MRF stages of
    one FRAME_BUCKET decode at B = 1: equal to the launcher `mrf_stage`,
    and within K1's bound (1e-4 * max(1, max|plain|)) of the plain version.
    Then v1.json at full
    width (phase 5's f32 synthesizer) at text bucket EXPORT_TEXT and frame
    bucket FRAME_BUCKET, and the vits2_vocos_v1.json decoder at the same
    frame bucket, saved as .pt2 files and loaded back. The encoder graph
    fed `encoder_noise(seed)` gives the live `encode_infer`'s z on the same
    draws within 2e-4 and its y_length; each decoder graph on that z the
    live decode's audio within 2e-4 * max(1, max|live|); the v1 decoder
    graph launches K1 (`mrf_stage_op`) 72 times a decode. Export seconds
    and bytes per graph; the decoder graphs' ms beside the live decoders'
    (CUDA events around EXPORT_REPS calls back to back, in turns); the
    host's us of one stage call through the operator and through the
    launcher beside the live v1 decode's wall ms. One `export` line."""
    from wetts_tpu_torch.bin import export_graphs as eg
    from wetts_tpu_torch.models.mrf import (
        mrf_stage,
        mrf_stage_as_op,
        mrf_stage_reference,
    )
    from wetts_tpu_torch.models.synthesizer import Synthesizer
    from wetts_tpu_torch.ops import random

    model = copy.deepcopy(model).eval()
    vcfg = vits2_config(VITS2_CONFIG, N_PHONES)
    vocos = random_init_(Synthesizer(vcfg), SEED).cuda().eval()
    out = {"op_vs_launcher_equal": True, "op_vs_plain_max_rel": 0.0}
    # the operator against the launcher (equal) and the plain version (K1's
    # bound) at each v1 stage's shape of one FRAME_BUCKET decode; then the
    # host's us of one call of each, OP_HOST_REPS in alternating order (the
    # device idle before each call, so that no queue is waited for)
    dec, m_cfg = model.dec, cfg.model
    t = FRAME_BUCKET
    host_us = {"launcher": [], "op": []}
    with torch.no_grad():
        form = dec.form("f32")
        for i, (stage, packed) in enumerate(zip(form.stages, form.packed)):
            t *= m_cfg.upsample_rates[i]
            c = stage[0][0][0].shape[0]
            h = torch.randn(1, t, c, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(i))
            args = (stage, m_cfg.resblock, dec.kernel_sizes, dec.dilations)
            got = mrf_stage_as_op(h, *args, packed)
            out["op_vs_launcher_equal"] &= bool(torch.equal(
                got, mrf_stage(h, *args, checked=True, packed=packed)))
            plain = mrf_stage_reference(h, *args)
            out["op_vs_plain_max_rel"] = max(
                out["op_vs_plain_max_rel"], float((got - plain).abs().max())
                / max(1.0, float(plain.abs().max())))
            calls = {"launcher": lambda: mrf_stage(
                         h, *args, checked=True, packed=packed),
                     "op": lambda: mrf_stage_as_op(h, *args, packed)}
            us = {k: [] for k in calls}
            for r in range(OP_HOST_REPS):
                for key in (("launcher", "op") if r % 2 == 0
                            else ("op", "launcher")):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    calls[key]()
                    us[key].append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize()
            for key in us:
                host_us[key].append(spread(us[key]))
    check(out["op_vs_launcher_equal"] and out["op_vs_plain_max_rel"] <= 1e-4,
          f"K1's operator: {out}")
    out["stage_call_host_us"] = host_us
    # what the operator adds to a decode's four stage calls (p50s)
    out["op_extra_host_us_per_decode"] = sum(
        o["p50"] - l["p50"] for o, l in zip(host_us["op"],
                                            host_us["launcher"]))
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        graphs = {}
        for name, c, m, texts in (("v1", cfg, model, [EXPORT_TEXT]),
                                  ("vits2_vocos_v1", vcfg, vocos, [])):
            t0 = time.perf_counter()
            g = eg.export_graphs(c, m, texts, [FRAME_BUCKET])
            out[f"{name}_export_s"] = time.perf_counter() - t0
            man = eg.write_graphs(g, os.path.join(tmp, name), {})
            out[f"{name}_bytes"] = {k: v["bytes"] for k, v in
                                    man["graphs"].items()}
            graphs[name] = {k: torch.export.load(os.path.join(
                tmp, name, f"{k}.pt2")).module() for k in man["graphs"]}
        rng = np.random.default_rng(SEED)
        x = torch.from_numpy(rng.integers(1, N_PHONES, (1, EXPORT_TEXT))
                             ).cuda()
        xl = torch.tensor([EXPORT_TEXT - 5], device="cuda")
        sid = torch.tensor([1], device="cuda")
        noise = eg.encoder_noise(cfg, 7, EXPORT_TEXT, device="cuda")
        with torch.no_grad():
            z, y_len = graphs["v1"][f"encoder_t{EXPORT_TEXT}"](x, xl, sid,
                                                                *noise)
            with random.supplied(noise):
                z_live, y_live, *_ = model.encode_infer(
                    x, xl, sid, 0.667, 1.0, 0.8,
                    max_frames=12 * EXPORT_TEXT)
            out["z_max_abs"] = float((z - z_live).abs().max())
            check(out["z_max_abs"] <= 2e-4 and torch.equal(y_len, y_live),
                  f"the encoder graph's z is {out['z_max_abs']} from the "
                  f"live model's (y_length {y_len} / {y_live})")
            zb = z[:, :FRAME_BUCKET].contiguous()
            for name, m in (("v1", model), ("vits2_vocos_v1", vocos)):
                dec = graphs[name][f"decoder_f{FRAME_BUCKET}"]
                mrf_stage.launches = 0
                audio = dec(zb, sid)
                torch.cuda.synchronize()
                n = mrf_stage.launches
                live = m.decode(zb, sid=sid)
                err = float((audio - live).abs().max())
                bound = 2e-4 * max(1.0, float(live.abs().max()))
                out[f"{name}_audio_max_abs"] = err
                check(err <= bound, f"{name}'s decoder graph is {err} from "
                      f"the live decode (bound {bound})")
                want = 72 if name == "v1" else 0
                check(n == want, f"{name}'s decoder graph launched K1 {n} "
                      f"times, not {want}")
                launches += n
                if name == "v1":
                    # the live B = 1 decode's wall ms, one decode at a time
                    wall = []
                    for _ in range(OP_HOST_REPS):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        m.decode(zb, sid=sid)
                        torch.cuda.synchronize()
                        wall.append((time.perf_counter() - t0) * 1e3)
                    out["v1_live_decode_wall_ms"] = spread(wall)
                # in turns, CUDA events around EXPORT_REPS calls back to
                # back: the device's time, or the host's where it is the
                # slower (a B = 1 decode takes the host as long to queue as
                # a sleep of 27 ms, so device_ms cannot hide it)
                calls = {"graph": lambda: dec(zb, sid),
                         "live": lambda: m.decode(zb, sid=sid)}
                times = {k: [] for k in calls}
                for key in ("graph", "live", "live", "graph"):
                    mrf_stage.launches = 0
                    times[key].append(cuda_ms(calls[key], EXPORT_REPS))
                    if key == "graph":
                        launches += mrf_stage.launches
                out[f"{name}_decode_ms"] = {k: float(np.mean(v))
                                            for k, v in times.items()}
    out["mrf_stage_launches"] = launches
    print("export " + json.dumps(out))
    return out


def frontend_corpus(d: str, vocab: dict, pinyin2id: dict, hanzi) -> tuple:
    """Seeded synthetic supervision in the reference's formats under d:
    polyphone lines (hanzi with one `▁pinyin▁` label) and prosody lines
    (words of 1-3 hanzi, each followed by a rank #1-#4), and vocab.txt;
    (vocab path, polyphone file, prosody file)."""
    rng = np.random.default_rng(SEED)
    prons = sorted(pinyin2id, key=pinyin2id.get)

    def chars(n):
        return "".join(hanzi[int(i)] for i in rng.integers(0, len(hanzi), n))

    os.makedirs(d)
    paths = [os.path.join(d, n) for n in ("vocab.txt", "poly.txt",
                                           "pros.txt")]
    with open(paths[0], "w", encoding="utf8") as f:
        f.writelines(t + "\n" for t in sorted(vocab, key=vocab.get))
    with open(paths[1], "w", encoding="utf8") as f:
        for _ in range(FRONTEND_POLY_LINES):
            pron = prons[int(rng.integers(0, len(prons)))]
            f.write(f"{chars(int(rng.integers(4, 12)))}▁{pron}▁"
                    f"{chars(int(rng.integers(2, 10)))}\n")
    with open(paths[2], "w", encoding="utf8") as f:
        for _ in range(FRONTEND_PROSODY_LINES):
            words = [f"{chars(int(rng.integers(1, 4)))} "
                     f"#{int(rng.integers(1, 4))}"
                     for _ in range(int(rng.integers(3, 9)))]
            f.write(" ".join(words)[:-1] + "4\n")
    return tuple(paths)


def phase_frontend_train(cfg, model, tmp: str) -> tuple:
    """The frontend's trainer (`frontend/train.py`) on the card at
    bert-base-chinese's geometry (hidden 768, 12 layers, vocab 21128;
    random weights, the vendored tables' hanzi as its vocabulary): one
    epoch of FRONTEND_BATCH batches over FRONTEND_POLY_LINES polyphone and
    FRONTEND_PROSODY_LINES prosody lines (a prosody-only batch among them,
    whose polyphone loss must be 0) through `FrontendTrainer.train`, every
    loss finite, the CV accuracies and `params.npz`; then `export_frontend
    --bf16 --verify` (cosine of the posteriors above 0.95) into a model
    bundle of phase 5's f32 synthesizer (durations scaled as phase 5b's),
    served by `cli.model.Model` on the card. FRONTEND_TIMED_STEPS more
    steps after the epoch give the step's host ms; the bundle answers a
    pass over SERVED_TEXTS texts (every shape warmed), then SERVED_REQUESTS
    requests cycling through them, each timed. Returns (the
    `frontend_train` line's dict, the bundle, its texts, the Model's int16
    audio of the first text as its first request)."""
    import contextlib as ctx
    import dataclasses

    from wetts_tpu_torch.bin import export_frontend
    from wetts_tpu_torch.bin.train_frontend import build_model
    from wetts_tpu_torch.cli.model import Model
    from wetts_tpu_torch.frontend.dataset import (
        IGNORE_ID,
        CharTokenizer,
        FrontendDataset,
    )
    from wetts_tpu_torch.frontend.train import FrontendTrainer
    from wetts_tpu_torch.models.bert_frontend import BertConfig
    from wetts_tpu_torch.models.mrf import mrf_stage
    from wetts_tpu_torch.utils.convert import convert_synthesizer
    from wetts_tpu_torch.utils.params_io import save_params_npz

    vocab, lexicon, pinyin2id, _, _, phones = frontend_tables()
    hanzi = [w for w in lexicon.words() if len(w) == 1]
    vocab_path, poly, pros = frontend_corpus(
        os.path.join(tmp, "frontend_data"), vocab, pinyin2id, hanzi)
    tok = CharTokenizer(vocab_path)
    prosody = {f"#{i}": i for i in range(5)}
    train_ds = FrontendDataset(tok, poly, pinyin2id, pros, prosody)
    cv_ds = FrontendDataset(tok, poly, pinyin2id, None, prosody)
    bert = BertConfig()
    fm, mc = build_model(bert, len(pinyin2id), 5)
    run = os.path.join(tmp, "frontend_run")
    os.makedirs(run)
    with open(os.path.join(run, "config.json"), "w") as f:
        json.dump(mc, f)
    trainer = FrontendTrainer(fm, train_ds, cv_ds, run, epochs=1,
                              batch_size=FRONTEND_BATCH)
    steps = []
    step = trainer.train_step

    def timed_step(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in step(batch).items()}
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "prosody_only": bool((batch[2] == IGNORE_ID).all()),
                      **metrics})
        return metrics

    trainer.train_step = timed_step
    last = trainer.train()
    n_steps, epoch = len(steps) + FRONTEND_TIMED_STEPS, 1
    while len(steps) < n_steps:
        for batch in train_ds.batches(FRONTEND_BATCH, epoch):
            if len(steps) < n_steps:
                timed_step(batch)
        epoch += 1
    # the first step of the run apart: it builds cuBLAS's plans
    out = {"steps": len(steps), "first_step_ms": steps[0]["ms"],
           "step_ms": spread([s["ms"] for s in steps[1:]]), "last": last}
    check(all(np.isfinite(v) for s in steps for v in s.values()),
          f"a frontend step's loss is not finite: {steps}")
    only = [s for s in steps if s["prosody_only"]]
    check(only and all(s["loss_phone"] == 0.0 for s in only),
          f"no prosody-only batch with a polyphone loss of 0: {steps}")
    out["prosody_only_batches"] = len(only)
    check(os.path.exists(os.path.join(run, "params.npz")),
          "the trainer wrote no params.npz")

    # the bundle: phase 5's synthesizer, the exported bf16 frontend
    bundle = os.path.join(tmp, "bundle")
    phone2id = {ph: i % N_PHONES for i, ph in enumerate(phones)}
    write_tables(bundle, phone2id, CONFIG)
    model = copy.deepcopy(model).eval()
    with torch.no_grad():
        p = dict(model.named_parameters())
        p["dp.flows.0.m"][0] -= (BUNDLE_LOG_DURATION_SHIFT
                                 * torch.exp(p["dp.flows.0.logs"][0]))
    save_params_npz(os.path.join(bundle, "params.npz"), convert_synthesizer(
        {k: v.cpu().numpy() for k, v in model.state_dict().items()}, cfg))
    said = io.StringIO()
    t0 = time.perf_counter()
    with ctx.redirect_stdout(said):
        export_frontend.main([
            "--model_dir", run, "--vocab", vocab_path, "--out_dir",
            os.path.join(bundle, "frontend"), "--bf16", "--verify"])
    out["export_frontend_s"] = time.perf_counter() - t0
    out["export_verify_cosine"] = float(
        said.getvalue().split("similarity =")[1].split()[0])
    check(out["export_verify_cosine"] > 0.95, "export_frontend --verify")

    rng = np.random.default_rng(SEED + 1)
    texts = [stream_text(rng, hanzi, 1) for _ in range(SERVED_TEXTS)]
    served = Model(bundle)
    check(served.engine.frontend is not None, "the bundle's frontend is "
          "not served")
    mrf_stage.launches = 0
    audios = [served.synthesis(text, "spk1") for text in texts]
    check(all(a.size and np.abs(a).max() > 0 for a in audios),
          "the bundle served empty audio")
    ms = []
    for i in range(SERVED_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served.synthesis(texts[i % len(texts)], "spk1")
        ms.append((time.perf_counter() - t0) * 1e3)
    out["request_ms"] = spread(ms)
    out["mrf_stage_launches"] = mrf_stage.launches
    out["audio_s"] = spread([a.size / cfg.data.sampling_rate
                             for a in audios])
    out["bert"] = dataclasses.asdict(bert)
    print("frontend_train " + json.dumps(out))
    return out, bundle, texts, audios[0]


def phase_native(bundle: str, texts, first_audio) -> dict:
    """The native binaries on the port (`utils/native_build.py`): g++
    builds `tts_main`, `http_server_main` (the repo's `native/src`, its
    `embed_engine.cc` importing the port's module) and `libwetts_text.so`;
    `tts_main` on the card (WETTS_DEVICE unset) writes the WAV of
    phase_frontend_train's bundle and first text within 1 int16 LSB of the
    Model's first request; then
    `http_server_main` answers `/` with the same audio (its first request),
    then `/` and `/stream` for each of the other texts (every shape
    warmed), then SERVED_REQUESTS `/` requests and as many `/stream`
    requests cycling through the texts, each timed (`/stream`: to its first
    chunk and to its end). One `native` line."""
    from wetts_tpu_torch.text import native
    from wetts_tpu_torch.utils import native_build

    out = {}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        bins = dict(zip(native_build.TARGETS,
                        pool.map(native_build.build, native_build.TARGETS)))
    out["build_s"] = time.perf_counter() - t0
    native._SEARCHED = False
    check(native.available() and native.sentence_segment("你好。再见。")
          == ["你好。", "再见。"], "libwetts_text.so does not answer")
    env = native_build.run_env()
    env.pop("WETTS_DEVICE", None)
    env.pop("WETTS_PRECISION", None)
    with open(os.path.join(bundle, "config.json")) as f:
        rate = json.load(f)["data"]["sampling_rate"]
    with tempfile.TemporaryDirectory() as tmp:
        wav_path = os.path.join(tmp, "out.wav")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [str(bins["tts_main"]), "--model_dir", bundle, "--text",
             texts[0], "--wav_path", wav_path, "--sname", "spk1",
             "--repo_root", ROOT], env=env, capture_output=True, text=True,
            timeout=300)
        out["tts_main_wall_s"] = time.perf_counter() - t0
        check(proc.returncode == 0, f"tts_main exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        with wave.open(wav_path) as w:
            check(w.getframerate() == rate, "tts_main's rate")
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    out["tts_main_lsb"] = int16_max_diff([pcm], [first_audio])
    check(out["tts_main_lsb"] <= 1, f"tts_main's audio is "
          f"{out['tts_main_lsb']} LSB from the Model's")
    port = free_port()
    server = subprocess.Popen(
        [str(bins["http_server_main"]), "--model_dir", bundle, "--port",
         str(port), "--repo_root", ROOT], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 240
        while True:
            check(server.poll() is None and time.time() < deadline,
                  "http_server_main did not start")
            try:
                http.client.HTTPConnection("127.0.0.1", port,
                                           timeout=1).connect()
                break
            except OSError:
                time.sleep(0.5)
        out["http_first_lsb"] = int16_max_diff([http_wav(port, texts[0])],
                                               [first_audio])
        check(out["http_first_lsb"] <= 1, "http_server_main's first "
              f"request is {out['http_first_lsb']} LSB from the Model's")
        for text in texts:
            wav = http_wav(port, text)
            pcm, _ = read_stream(port, text)
            check(wav.size > 0 and pcm.size > 0 and np.abs(pcm).max() > 0,
                  "http_server_main answered empty audio")
        request_ms, first_ms, stream_ms = [], [], []
        for i in range(SERVED_REQUESTS):
            t0 = time.perf_counter()
            wav = http_wav(port, texts[i % len(texts)])
            request_ms.append((time.perf_counter() - t0) * 1e3)
            check(wav.size > 0, "http_server_main answered empty audio")
        for i in range(SERVED_REQUESTS):
            t0 = time.perf_counter()
            pcm, first = read_stream(port, texts[i % len(texts)])
            stream_ms.append((time.perf_counter() - t0) * 1e3)
            first_ms.append(first)
            check(pcm.size > 0, "http_server_main streamed no audio")
        out["http_request_ms"] = spread(request_ms)
        out["stream_first_chunk_ms"] = spread(first_ms)
        out["stream_ms"] = spread(stream_ms)
    finally:
        server.kill()
        server.wait(timeout=30)
    print("native " + json.dumps(out))
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
    phase_chunk_kernels(engine.model, cfg.model)
    v1_stages = phase_model_stages(engine.model, {
        "f32": sum(r["ms"] for r in rows),
        "bf16": sum(r["ms"] for r in rows_bf16),
        "int8": sum(r["ms"] for r in q["stage"])})
    print("model_stages " + json.dumps(v1_stages))
    del engine
    torch.cuda.empty_cache()
    chain = phase_chain()

    # ---- the serving main path, once per precision (same seeds each time)
    exact, synth, launches, v1_model = serve_precision(cfg, "f32", SEED,
                                                       True)
    half, synth_bf16, launches_bf16, _ = serve_precision(cfg, "bf16", SEED,
                                                         False)
    quant, synth_int8, launches_int8, _ = serve_precision(cfg, "int8", SEED,
                                                          True)
    compare_with_f32("bf16", half, exact, 0.995)
    compare_with_f32("int8", quant, exact, 0.99)
    print("serving " + json.dumps({
        s["precision"]: {"audio_s_per_s": s["audio_s_per_s"],
                         "batch_ms_p50": s["batch_ms_p50"]}
        for s in (synth, synth_bf16, synth_int8)}))
    bundle = phase_bundle(cfg, v1_model)
    export = phase_export(cfg, v1_model)
    with tempfile.TemporaryDirectory() as tmp:
        frontend_train, fe_bundle, fe_texts, fe_audio = phase_frontend_train(
            cfg, v1_model, tmp)
        phase_native(fe_bundle, fe_texts, fe_audio)
    del v1_model
    torch.cuda.empty_cache()
    fe = build_frontend()
    phase_streaming(cfg, card, fe)
    torch.cuda.empty_cache()
    vocos_kernels = phase_vocos_kernels()
    vits2 = phase_vits2(card, v1_stages, fe)
    del fe

    mas_rows = phase_mas_kernel()
    training, train_launches = phase_training(cfg)
    print("training " + json.dumps(training))
    torch.cuda.empty_cache()
    vits2_training, vits2_mas_launches, k2_vits2 = phase_vits2_training(card)
    print("vits2_training " + json.dumps(vits2_training))
    torch.cuda.empty_cache()
    bf16_training, bf16_mas_launches, k2_bf16 = phase_bf16_wd_training(
        card, vits2_training)
    print("bf16_wd_training " + json.dumps(bf16_training))
    torch.cuda.empty_cache()
    dp = phase_dp()
    print("train_reference " + json.dumps(phase_train_reference()))
    v1_rows = [r for r in mas_rows
               if (r["B"], r["T_spec"], r["T_text"]) in MAS_V1_SHAPES]

    def total(rows_, key):
        return sum(r[key] for r in rows_)

    # the chain of dependent operations is a bound by operations
    mas_bound_by = ("bytes" if total(v1_rows, "bytes_ms")
                    >= total(v1_rows, "chain_ms") else "operations")

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
    def served(name, key):
        """launches of the bundle phase's requests at `name`."""
        return sum(bundle[b]["launches"][key] for b in
                   (("f32", "f32_folded") if name == "f32" else (name,)))

    kernels = [
        kernel("mrf_stage", "mrf_stage.cu",
               "wetts_tpu/models/mrf_pallas.py:172",
               launches["mrf_stage"] + vits2["f32"]["mrf_stage"]
               + served("f32", "mrf_stage") + train_launches["mrf"]
               + export["mrf_stage_launches"]
               + frontend_train["mrf_stage_launches"],
               rows, "operations", total(rows, "library_ms")),
        kernel("mrf_stage_bf16", "mrf_stage.cu",
               "wetts_tpu/models/mrf_pallas.py:172",
               launches_bf16["mrf_stage"] + vits2["bf16"]["mrf_stage"]
               + served("bf16", "mrf_stage"),
               rows_bf16, "operations", total(rows_bf16, "library_ms")),
        kernel("mas", "mas.cu", "wetts_tpu/ops/mas_pallas.py:81",
               train_launches["mas"] + dp["mas_launches"], v1_rows,
               mas_bound_by),
        # K2 at the VITS2 step's noised scores, its launches those of both
        # VITS2 training main paths
        kernel("mas_vits2", "mas.cu", "wetts_tpu/ops/mas_pallas.py:81",
               vits2_mas_launches, [k2_vits2],
               "bytes" if k2_vits2["bound_by"] == "bytes" else "operations"),
        # K2 on the bf16 step's (f32) scores, its launches those of the
        # bf16 + WavLM discriminator main path
        kernel("mas_vits2_bf16", "mas.cu", "wetts_tpu/ops/mas_pallas.py:81",
               bf16_mas_launches, [k2_bf16],
               "bytes" if k2_bf16["bound_by"] == "bytes" else "operations"),
        kernel("int8_conv", "int8_mrf_conv.cu", q8,
               launches_int8["int8_conv"] + vits2["int8"]["int8_conv"]
               + served("int8", "int8_conv"),
               q["stage"], "operations", total(q["stage"], "library_ms")),
        kernel("int8_conv_transpose", "int8_mrf_conv.cu", q8,
               launches_int8["int8_conv_transpose"]
               + vits2["int8"]["int8_conv_transpose"]
               + served("int8", "int8_conv_transpose"), q["up"], "bytes",
               total(q["up"], "library_ms")),
        kernel("int8_row_scale", "int8_conv.cu",
               "wetts_tpu/models/hifigan_fast.py:141",
               launches_int8["int8_row_scale"]
               + vits2["int8"]["int8_row_scale"]
               + served("int8", "int8_row_scale"), q["scale"], "bytes"),
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
    # VB: ms, plain_ms, library_ms and bound_ms of one backbone's 18 GEMMs
    # and 10 row launches at 8 x 1153 frames; its GEMMs' bound is that of 3
    # TF32 products per f32 product, their library_ms the module path's 18
    # cuDNN f32 1x1 convs alone, the row launches' the 10 F.layer_norm
    for name, what in (("vocos_gemm", "gemm"), ("vocos_rownorm", "rownorm")):
        r = vocos_kernels[what]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "wetts_tpu_torch/csrc/vocos_backbone.cu",
            "replaces": "none (the Vocos backbone's cuDNN f32 convs)",
            "launches": vits2["vits2_vocos"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "operations" if what == "gemm" else "bytes",
            "library_ms": r["library_ms"]})
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
