"""decode_ms.<kind>: host milliseconds per engine call of the `decode`
stage of serving/engine.py's StageTimes (HiFi-GAN with K1, or Vocos with
its iSTFT; the stage ends in the audio's copy to the host), over the
untraced window's calls."""


def read(run):
    st = (run.record.get("stage_times") or {}).get("decode")
    if not st:
        return None
    return 1e3 * st["total_s"] / st["n"]
