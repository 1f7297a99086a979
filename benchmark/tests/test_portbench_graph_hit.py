"""graph_hit: the share of the engine's encode and flow stages that
replayed a graph captured before them, read from the window's StageTimes
report; nothing where the program records no graph stage (a program
without graphs, or the CPU)."""

import pytest

from benchmark import harness
from benchmark.harness import Run

READER = harness.load_module("metrics", "graph_hit.batch")


def run_with(stage_times):
    run = Run(name="vits_v1.batch", cell={}, cfg={}, mix={}, seed=0,
              seconds=1.0, trace=True, device=None, t_start=0.0)
    if stage_times is not None:
        run.record["stage_times"] = stage_times
    return run


def stage(n):
    return {"n": n, "total_s": 1e-3 * n}


@pytest.mark.parametrize("stage_times", [
    None,
    {},
    {"encode": stage(400), "flow": stage(400), "decode": stage(400)},
    {"encode": stage(400), "decode": stage(400), "graph_replay": stage(3)},
])
def test_nothing_to_read_without_graph_stages(stage_times):
    assert READER.read(run_with(stage_times)) is None


def test_replays_less_captures_over_the_stages():
    # 400 calls: 7 keys captured in the window (each capture replayed
    # once), 2 stages of keys seen for the first time ran eagerly
    st = {"encode": stage(400), "flow": stage(400), "decode": stage(400),
          "graph_capture": stage(7), "graph_replay": stage(798)}
    assert READER.read(run_with(st)) == pytest.approx(100.0 * 791 / 800)
    # every key captured before the window
    st = {"encode": stage(10), "flow": stage(10), "graph_replay": stage(20)}
    assert READER.read(run_with(st)) == 100.0


def test_the_batch_cell_reports_it_traced():
    bench = harness.load_benchmark()
    traced = {m["name"] for m in harness.cell_metrics(
        bench, "vits_v1.batch", True)}
    untraced = {m["name"] for m in harness.cell_metrics(
        bench, "vits_v1.batch", False)}
    assert "graph_hit.batch" in traced and "graph_hit.batch" not in untraced
