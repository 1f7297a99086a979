"""k1_roofline.<kind>: kernel K1 (models/mrf.py + csrc/mrf_stage.cu) as a
share (%) of its roofline in a traced slice: `.batch` at the batch cells'
padded batches, `.stream` at the stream's stacked 60-frame chunks.

The work is the MRF algorithm's, counted by benchmark/flops.py at each
decoder call's input shape as the decoder received it (a forward pre-hook
on the synthesizer's `dec`): 2 * C * C * taps per sample, and the input,
output, weights and biases each moved once in f32. Its least time is
max(operations / 989e12, bytes / 3.35e12): the dense bf16 tensor rate,
because K1 builds f32 results from TF32 tensor products and no product that
meets the f32 tolerance runs faster than the fastest floating tensor rate,
so the share cannot pass 100% whatever a later change implements. K1's
time is the device time of the kernels whose names match KERNEL in the
profiler's trace. Without such kernels, or without decoder calls, there is
nothing to read."""

import re

from benchmark.flops import decoder_mrf_cost
from benchmark.peaks import PEAK_BYTES, PEAK_FLOPS

KERNEL = re.compile(r"mrf_conv_kernel<float")


def read(run):
    trace, shapes = run.trace_data, run.record.get("decoder_shapes")
    if trace is None or not shapes:
        return None
    k1_s = trace.op_seconds(KERNEL)
    if k1_s <= 0:
        return None
    m = run.cfg["model"]
    if m.get("vocoder_type", "hifigan") != "hifigan":
        return None
    least = 0.0
    for b, _, frames in shapes:
        ops, nbytes = decoder_mrf_cost(m, b, frames)
        least += max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
    return 100.0 * least / k1_s
