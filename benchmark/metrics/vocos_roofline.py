"""vocos_roofline.<kind>: the Vocos decoder's backbone (models/vocos.py, its
in_conv, ConvNeXt layers and out_conv) as a share (%) of its roofline over
the untraced window.

The engine counts every decode's rows and rows x padded latent frames
(StageTimes counters `decode_rows`, `decode_frames`) and the decoder times
its backbone on the device (the device stage `vocos`, two CUDA events a
decode). The work (benchmark/vocos_cost.py) is affine in rows and frames,
so the counters give the window's operations and bytes. The least time is
max(operations / 989e12, bytes / 3.35e12) of these sums (benchmark/peaks.py
says why the dense bf16 rate bounds f32 work). Summed decode by decode it
is the same wherever every decode lies on one side of the ridge (at the
published widths some 625 frames a decode of 8 rows, where the weights'
53.5 MB are read in the time of the operations), as every decode of the
batch cells does (8 rows of at least 96 frames); elsewhere it reads low,
never high. Nothing to read where the stage or a counter is missing (a program
without them) or the decoder is not Vocos."""

from benchmark.peaks import PEAK_BYTES, PEAK_FLOPS
from benchmark.vocos_cost import backbone_cost


def read(run):
    m = run.cfg.get("model", {})
    st = run.record.get("stage_times") or {}
    if (m.get("vocoder_type") != "vocos"
            or not all(k in st for k in ("vocos", "decode_rows",
                                         "decode_frames"))):
        return None
    vocos_s = st["vocos"]["total_s"]
    if vocos_s <= 0:
        return None
    ops, nbytes = backbone_cost(m, st["decode_rows"]["n"],
                                st["decode_rows"]["count"],
                                st["decode_frames"]["count"])
    return 100.0 * max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES) / vocos_s
