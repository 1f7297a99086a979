"""mfu: the model's floating work over the window, at each request's
realized text length and frame count, as a share (%) of the window's wall
seconds times the H100's dense bf16 tensor peak (benchmark/peaks.py says
why that rate bounds f32 work too). The work comes from benchmark/flops.py:
convolutions, transposed convolutions, linear maps and attention products,
with elementwise operations, the prior's gather and the iSTFT's FFT left
out. Read in the untraced window."""

from benchmark.flops import request_flops
from benchmark.peaks import PEAK_FLOPS


def read(run):
    calls = run.record.get("calls")
    if not calls or not run.window_s:
        return None
    hop = 1
    for u in run.cfg["model"]["upsample_rates"]:
        hop *= u
    work = sum(request_flops(run.cfg, len(ids), samples // hop)
               for c in calls for ids, samples in zip(c["ids"],
                                                      c["samples"]))
    return 100.0 * work / (run.window_s * PEAK_FLOPS)
