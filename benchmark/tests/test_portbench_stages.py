"""The device's work read by engine stage (`benchmark/stages.py`): device
operations clipped to the program's `wetts.<stage>` spans, their busy time
a union, operations counted by where they start, and the stages' idle time
adding up with the rest to the device's idle time. On the CPU, a traced
batch slice carries the spans of every call, and the program's spans leave
the harness's own reading of the trace as it was."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, stages
from benchmark.harness import TraceData
from benchmark.tests.tiny import tiny_batch_mix, tiny_config
from benchmark.tools.stage_trace import slice_line
from wetts_tpu_torch.utils.profiling import StageTimes


def covered(intervals, length):
    """A boolean per nanosecond of [0, length): covered by an interval."""
    grid = np.zeros(length, bool)
    for _, s, e in intervals:
        grid[s:e] = True
    return grid


def test_ops_are_clipped_at_a_spans_edges():
    spans = [("encode", 10, 30)]
    ops = [("a", 0, 15), ("b", 25, 40), ("c", 40, 50)]
    assert stages.busy_ns(ops, spans, ("encode",)) == 5 + 5
    assert stages.idle_ns(ops, spans, ("encode",)) == 20 - 10


def test_busy_time_is_a_union_not_a_sum():
    spans = [("encode", 0, 30), ("flow", 40, 60)]
    ops = [("a", 5, 20), ("b", 10, 25), ("c", 12, 14), ("d", 45, 50),
           ("e", 45, 55)]
    assert stages.busy_ns(ops, spans, stages.ENCODE_FLOW) == 20 + 10
    assert stages.busy_ns(ops, spans, ("flow",)) == 10
    assert stages.union(ops) == [(5, 25), (45, 55)]


def test_ops_count_by_their_start():
    spans = [("encode", 10, 20), ("flow", 20, 30), ("decode", 40, 60)]
    ops = [("before", 5, 15),     # ends inside encode: not counted
           ("edge", 10, 12),      # starts at encode's start
           ("over", 18, 35),      # starts in encode, ends past flow
           ("flow", 29, 31),
           ("gap", 30, 45),       # starts at flow's end: outside
           ("dec", 41, 42)]
    assert stages.ops_started(ops, spans, stages.ENCODE_FLOW) == 3
    assert stages.ops_started(ops, spans, stages.DECODE) == 1
    assert stages.ops_started(ops, [], stages.ENCODE_FLOW) == 0


def test_idle_shares_add_up_to_the_device_idle():
    # two calls of encode, flow and decode, host gaps between them; every
    # span lies between the first operation's start and the last's end
    rng = np.random.default_rng(3)
    spans, ops, t = [], [("first", 0, 4)], 6
    for _ in range(2):
        for stage in ("encode", "flow", "decode"):
            length = int(rng.integers(20, 40))
            spans.append((stage, t, t + length))
            for _ in range(4):
                s = t + int(rng.integers(0, length))
                ops.append(("op", s, s + int(rng.integers(1, 15))))
            t += length + int(rng.integers(2, 6))
    ops.append(("last", t, t + 5))
    end = t + 5
    trace = TraceData(window_s=end * 1e-9, device_ops=ops, spans=[])
    idle_between = end - round(trace.busy_s() * 1e9)
    busy, span_grid = covered(ops, end), covered(spans, end)
    outside = int(np.sum(~busy & ~span_grid))
    ef = stages.idle_ns(ops, spans, stages.ENCODE_FLOW)
    dec = stages.idle_ns(ops, spans, stages.DECODE)
    assert ef == int(np.sum(~busy & covered(
        [sp for sp in spans if sp[0] != "decode"], end)))
    assert ef + dec + outside == idle_between
    r = stages.readings(ops, spans, trace.window_s)
    assert r["calls"] == 2
    assert r["encode_flow_idle"] + r["decode_idle"] + r["other_idle"] \
        == pytest.approx(100.0 * idle_between / end)
    assert r["encode_flow_busy_ms"] * 1e6 * 2 == pytest.approx(int(np.sum(
        busy & covered([sp for sp in spans if sp[0] != "decode"], end))))
    assert r["encode_flow_busy_ms"] <= r["encode_flow_span_ms"]


def test_no_encode_span_reads_nothing():
    ops = [("a", 0, 10)]
    assert stages.readings(ops, [], 1e-6) is None
    assert stages.readings(ops, [("decode", 0, 5)], 1e-6) is None


def test_program_spans_from_a_profile():
    st = StageTimes()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.synthesize_ids_batch"):
            for name in ("encode", "flow", "decode"):
                with st.stage(name):
                    torch.ones(4).sum()
    spans = stages.program_spans(prof)
    assert [n for n, _, _ in spans] == ["encode", "flow", "decode"]
    assert all(s <= e for _, s, e in spans)
    assert spans[0][2] <= spans[1][1] <= spans[1][2] <= spans[2][1]


def test_a_traced_batch_slice_reads_every_call(monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SLICE_S", 0.5)
    mix = tiny_batch_mix()
    run = harness.Run(name="vits_v1.batch", cell={"chips": 1},
                      cfg=tiny_config("vits_v1", 476), mix=mix, seed=31,
                      seconds=0.3, trace=True, device=torch.device("cpu"),
                      t_start=time.perf_counter())
    driver = harness.load_module("drivers", mix["driver"])
    state = driver.setup(run)
    driver.window(run, state)
    driver.trace(run, state)
    line = slice_line(run, state)
    assert line["slice_calls"] >= 1 and line["window_calls"] >= 1
    assert line["stages"]["calls"] == line["slice_calls"]
    assert line["stages"]["encode_flow_span_ms"] > 0
    # no device on the CPU: nothing busy, no operation inside a stage
    assert line["stages"]["encode_flow_busy_ms"] == 0
    assert line["stages"]["encode_flow_ops"] == 0
    # the harness's own spans, which name the breakdown's idle gaps,
    # leave the program's out
    assert {n for n, _, _ in run.trace_data.spans} == {
        "synthesize_ids_batch"}
