"""The device's work inside the program's own spans.

While torch.profiler records, each `StageTimes.stage(name)` of the port
(`wetts_tpu_torch/utils/profiling.py`) is also the user annotation
`wetts.<name>` on the profiler's timeline, which the device's operations
share. This module reads those spans from a finished profile and clips the
device operations' intervals to them: the device's busy time inside a set
of stages (the union of the clipped intervals, not their sum), the
operations that start inside them, and the stages' idle time (their length
less that busy time).

On `synthesize_ids_batch` every stage (`encode`, `flow`, `decode`) ends in a
device sync, so what the device does inside a stage's span is that stage's
own work, with nothing queued from the stage before it. The streaming path
queues every chunk's decode before its first wait, so there a stage's span
holds other stages' work: these readings are for the batch path only.

Intervals are (name, start_ns, end_ns), as `harness.TraceData` holds its
device operations.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PREFIX = "wetts."

Interval = Tuple[str, int, int]


def program_spans(prof) -> List[Interval]:
    """(stage, start_ns, end_ns) of every host-side user annotation of a
    finished torch.profiler profile whose name starts with PREFIX, the
    prefix dropped (their copies on the device's timeline left out)."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if (ev.is_user_annotation() and name.startswith(PREFIX)
                and ev.device_type().name != "CUDA"):
            out.append((name[len(PREFIX):], ev.start_ns(), ev.end_ns()))
    return sorted(out, key=lambda sp: sp[1])


def union(intervals: Iterable[Interval]) -> List[Tuple[int, int]]:
    """The intervals' union as sorted, disjoint (start, end) pairs."""
    out: List[Tuple[int, int]] = []
    for _, s, e in sorted(intervals, key=lambda iv: iv[1]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def overlap_ns(a: Sequence[Tuple[int, int]],
               b: Sequence[Tuple[int, int]]) -> int:
    """The length of the intersection of two unions (sorted, disjoint)."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def stage_union(spans: Iterable[Interval], names: Sequence[str]
                ) -> List[Tuple[int, int]]:
    return union(sp for sp in spans if sp[0] in names)


def busy_ns(ops: Iterable[Interval], spans: Iterable[Interval],
            names: Sequence[str]) -> int:
    """Nanoseconds in which at least one device operation ran inside a
    span of one of the stages `names`."""
    return overlap_ns(union(ops), stage_union(spans, names))


def ops_started(ops: Iterable[Interval], spans: Iterable[Interval],
                names: Sequence[str]) -> int:
    """Device operations (kernels, copies, memsets) that start inside a
    span of one of the stages `names`."""
    within = stage_union(spans, names)
    starts = [s for s, _ in within]
    n = 0
    for _, s, _ in ops:
        k = bisect.bisect_right(starts, s) - 1
        if k >= 0 and s < within[k][1]:
            n += 1
    return n


def idle_ns(ops: Iterable[Interval], spans: Iterable[Interval],
            names: Sequence[str]) -> int:
    """The stages' span time in which no device operation ran."""
    within = stage_union(spans, names)
    return (sum(e - s for s, e in within)
            - overlap_ns(union(ops), within))


ENCODE_FLOW = ("encode", "flow")
DECODE = ("decode",)


def readings(ops: Sequence[Interval], spans: Sequence[Interval],
             window_s: float) -> Optional[Dict[str, float]]:
    """A traced slice of batch calls, read by engine stage: a call is an
    `encode` span. Per call, the device's busy ms and operations inside
    `encode` and `flow`, and those spans' host ms; as shares (%) of the
    slice, the idle time inside `encode` and `flow`, inside `decode`, and
    the rest of the device's idle time (the caller, padding and trimming).
    None without an `encode` span."""
    calls = sum(1 for sp in spans if sp[0] == "encode")
    if not calls or window_s <= 0:
        return None
    slice_ns = window_s * 1e9
    ef_idle = idle_ns(ops, spans, ENCODE_FLOW)
    dec_idle = idle_ns(ops, spans, DECODE)
    all_idle = slice_ns - sum(e - s for s, e in union(ops))
    ef_span = sum(e - s for s, e in stage_union(spans, ENCODE_FLOW))
    return {
        "calls": calls,
        "encode_flow_busy_ms": 1e-6 * busy_ns(ops, spans, ENCODE_FLOW)
        / calls,
        "encode_flow_ops": ops_started(ops, spans, ENCODE_FLOW) / calls,
        "encode_flow_span_ms": 1e-6 * ef_span / calls,
        "encode_flow_idle": 100.0 * ef_idle / slice_ns,
        "decode_idle": 100.0 * dec_idle / slice_ns,
        "other_idle": 100.0 * (all_idle - ef_idle - dec_idle) / slice_ns,
    }
