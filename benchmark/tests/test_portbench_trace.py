"""The reading of a trace: the device's busy time is the union of its
operations' intervals, and each idle gap is named by the innermost
benchmark span open at its middle."""

import re

from benchmark.harness import TraceData


def test_busy_is_the_union():
    ops = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 32, 35)]
    trace = TraceData(window_s=100e-9, device_ops=ops, spans=[])
    assert abs(trace.busy_s() - 30e-9) < 1e-18
    assert abs(trace.op_seconds(re.compile("^[ab]$")) - 25e-9) < 1e-18


def test_breakdown_names_gaps_by_innermost_span():
    ops = [("k1", 0, 10), ("k1", 20, 30), ("conv", 60, 70)]
    spans = [("synthesize_ids_batch", 0, 35), ("submit", 15, 18),
             ("stream_next", 40, 80)]
    b = TraceData(1e-6, ops, spans).breakdown()
    assert b["device_ops"][0] == ["k1", 20e-9]
    idle = dict(b["idle_gaps"])
    assert abs(idle["submit"] - 10e-9) < 1e-18          # gap 10-20
    assert abs(idle["stream_next"] - 30e-9) < 1e-18     # gap 30-60
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
