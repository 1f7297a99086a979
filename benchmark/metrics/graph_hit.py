"""graph_hit.<kind>: the share (%) of the engine's encode and flow stages,
over the untraced window's calls, that replayed a CUDA graph captured
before the stage (serving/engine.py's StageTimes: `graph_replay` counts
every replay, `graph_capture` every capture, each capture followed by one
replay). None where the engine records no graph stage (a program without
graphs)."""


def read(run):
    st = run.record.get("stage_times") or {}
    if not all(k in st for k in ("encode", "flow", "graph_replay")):
        return None
    captures = st.get("graph_capture", {}).get("n", 0)
    stages = st["encode"]["n"] + st["flow"]["n"]
    return 100.0 * (st["graph_replay"]["n"] - captures) / stages
