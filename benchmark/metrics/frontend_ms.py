"""frontend_ms.<kind>: host milliseconds per clause of the `frontend`
stage of serving/engine.py's StageTimes (text normalization, G2P and the
BERT scorer, whose posteriors end on the host), over the untraced window's
clauses."""


def read(run):
    st = (run.record.get("stage_times") or {}).get("frontend")
    if not st:
        return None
    return 1e3 * st["total_s"] / st["n"]
