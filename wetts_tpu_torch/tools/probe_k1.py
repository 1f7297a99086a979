"""Probe: where does kernel K1 (`models/mrf.py:mrf_stage`) spend its time on
this GPU? The quick loop for work on `csrc/mrf_stage.cu`.

For bf16 and f32, at the four VITS-base MRF stage shapes of a batch of 4 at
the 352-frame decode bucket (ResBlock1, kernel sizes 3 / 7 / 11, dilations
1 / 3 / 5, seeded random weights): the whole stage's time beside cuDNN's
time for the stage's 18 convolutions alone (`F.conv1d`, TF32 off: the
yardstick, and a check of the card between two runs), the stage's error
against the plain version, and single launches of the narrowest and the
widest conv (3 taps, dilation 1; 11 taps, dilation 5) with a residual.
Timed with CUDA events; prints the card's name and power limit, ptxas's
register report, one JSON line per stage and type and one with the sums.

    python -m wetts_tpu_torch.tools.probe_k1

Needs an NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from wetts_tpu_torch.models import mrf
from wetts_tpu_torch.models.quant import STORE
from wetts_tpu_torch.utils import cuda_build

BATCH = 4
STAGES = ((256, 2816), (128, 22528), (64, 45056), (32, 90112))  # (C, T)
KERNEL_SIZES, DILATIONS = (3, 7, 11), ((1, 3, 5),) * 3


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` runs, after a warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@torch.no_grad()
def probe_stage(c: int, t: int, dtype: torch.dtype) -> dict:
    gen = torch.Generator().manual_seed(c)
    stage = [[((torch.randn(c, c, k, generator=gen) / (c * k) ** 0.5
                ).to("cuda", dtype),
               (torch.randn(c, generator=gen) * 0.1).to("cuda", dtype))
              for _ in range(2 * len(dils))]
             for k, dils in zip(KERNEL_SIZES, DILATIONS)]
    packed = mrf.pack_stage(stage)
    h = torch.randn(BATCH, t, c, generator=gen).to("cuda", dtype)
    args = ("1", KERNEL_SIZES, DILATIONS)
    got = mrf.mrf_stage(h, stage, *args, packed=packed)
    want = mrf.mrf_stage_reference(h, stage, *args)
    row = {"dtype": str(dtype).split(".")[1], "C": c, "T": t,
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "max_abs_plain": want.float().abs().max().item(),
           "stage_ms": device_ms(
               lambda: mrf.mrf_stage(h, stage, *args, packed=packed), 10)}
    ht = h.transpose(1, 2).contiguous()
    convs = [(w, k, d) for branch, k, dils in zip(stage, KERNEL_SIZES,
                                                  DILATIONS)
             for (w, _), d in zip(branch, [x for dil in dils
                                           for x in (dil, 1)])]
    row["cudnn_convs_ms"] = device_ms(lambda: [
        F.conv1d(ht, w, padding=(k - 1) * d // 2, dilation=d)
        for w, k, d in convs], 3)
    launch = mrf._launcher(h)
    out = torch.empty_like(h)
    for k, d in ((3, 1), (11, 5)):
        wp, bias = packed[KERNEL_SIZES.index(k)][0]
        row[f"conv_k{k}_d{d}_us"] = 1e3 * device_ms(
            lambda: launch(h, wp, bias, k, d, h, out, STORE, 1.0), 20)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k1: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    cuda_build.build("mrf_stage")
    for line in sorted({ln.strip() for ln in
                        cuda_build.compiler_log("mrf_stage").splitlines()
                        if "registers" in ln or "spill" in ln}):
        print(f"ptxas: {line}")
    sums = {}
    for dtype in (torch.bfloat16, torch.float32):
        for c, t in STAGES:
            row = probe_stage(c, t, dtype)
            sums[row["dtype"]] = sums.get(row["dtype"], 0.0) + row["stage_ms"]
            print(json.dumps(row))
            sys.stdout.flush()
    print(json.dumps({"k1_ms": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
