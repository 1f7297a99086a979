"""vocos_fused: the share of the window's decodes whose Vocos backbone ran
on the hand-written kernels, read from the window's StageTimes report;
nothing where the program counts no `vocos_fused` (a program without the
kernels) or the decoder is HiFi-GAN."""

import pytest

from benchmark import harness
from benchmark.harness import Run
from benchmark.system import load_config

READER = harness.load_module("metrics", "vocos_fused.batch")
CELL = "vits2_vocos_v1.batch"


def run_with(stage_times, config="vits2_vocos_v1"):
    run = Run(name=CELL, cell={}, cfg=load_config(config), mix={}, seed=0,
              seconds=1.0, trace=True, device=None, t_start=0.0)
    if stage_times is not None:
        run.record["stage_times"] = stage_times
    return run


def counter(n, count):
    return {"n": n, "count": count, "total_s": 0.0, "mean_ms": 0.0,
            "p50_ms": 0.0, "p99_ms": 0.0}


def stage(n):
    return {"n": n, "total_s": 1e-3 * n}


WINDOW = {"encode": stage(400), "flow": stage(400), "decode": stage(400),
          "vocos": stage(400), "istft": stage(400),
          "decode_rows": counter(400, 3200),
          "decode_frames": counter(400, 3200 * 1152)}


@pytest.mark.parametrize("stage_times", [None, {}, WINDOW])
def test_nothing_to_read_without_the_counter(stage_times):
    assert READER.read(run_with(stage_times)) is None


def test_nothing_to_read_for_hifigan():
    st = dict(WINDOW, vocos_fused=counter(400, 400))
    assert READER.read(run_with(st, config="vits_v1")) is None


@pytest.mark.parametrize("fused,want", [(400, 100.0), (0, 0.0),
                                        (300, 75.0)])
def test_fused_decodes_over_all_decodes(fused, want):
    st = dict(WINDOW, vocos_fused=counter(400, fused))
    assert READER.read(run_with(st)) == pytest.approx(want)


def test_the_vocos_cell_reports_it_traced():
    bench = harness.load_benchmark()
    traced = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    other = {m["name"] for m in harness.cell_metrics(
        bench, "vits_v1.batch", True)}
    assert "vocos_fused.batch" in traced
    assert "vocos_fused.batch" not in other
