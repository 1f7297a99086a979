"""encode_flow_ms.<kind>: host milliseconds per engine call of the
`encode` and `flow` stages of serving/engine.py's StageTimes (the encode
ends in the copy of the realized lengths to the host, the flow in a device
sync), over the untraced window's calls: the two stages' totals over their
count. One reader for every cell kind (`.batch`, `.serve`)."""


def read(run):
    st = run.record.get("stage_times") or {}
    if "encode" not in st or "flow" not in st:
        return None
    return 1e3 * (st["encode"]["total_s"] / st["encode"]["n"]
                  + st["flow"]["total_s"] / st["flow"]["n"])
