"""istft_ms.<kind>: device milliseconds per decode of the Vocos decoder's
inverse STFT (magnitude and phase from the backbone's output, then
ops/spectral.py's istft: cuFFT and the overlap-add), the device stage
`istft` of serving/engine.py's StageTimes over the untraced window. The
batch cells decode once a call. Nothing to read where the program has no
such stage."""


def read(run):
    st = (run.record.get("stage_times") or {}).get("istft")
    if not st or not st.get("n"):
        return None
    return 1e3 * st["total_s"] / st["n"]
