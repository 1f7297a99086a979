"""vocos_fused.<kind>: the share (%) of the untraced window's decodes whose
Vocos backbone ran on the hand-written kernels (models/vocos_backbone.py,
csrc/vocos_backbone.cu) rather than on its modules. The decoder counts
`vocos_fused` in the engine's StageTimes on every decode, 1 where it took
the kernels, else 0; the engine counts every decode in `decode_rows`. None
where the decoder is not Vocos or the program counts no `vocos_fused` (a
program without the kernels)."""


def read(run):
    m = run.cfg.get("model", {})
    st = run.record.get("stage_times") or {}
    if (m.get("vocoder_type") != "vocos"
            or not all(k in st for k in ("vocos_fused", "decode_rows"))
            or st["decode_rows"]["n"] <= 0):
        return None
    return 100.0 * st["vocos_fused"]["count"] / st["decode_rows"]["n"]
