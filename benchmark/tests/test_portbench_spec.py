"""BENCHMARK.json against the benchmark's contract, and every file it names:
each cell's configuration, traffic mix, driver and limits, each metric's
reader, and each configuration against the published recipe it copies."""

import json
import os
import re

import pytest

from benchmark import ROOT, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()
PUBLISHED = {"vits_v1": "examples/baker/configs/v1.json",
             "vits2_vocos_v1": "examples/baker/configs/vits2_vocos_v1.json"}


def bench_file(*parts):
    return os.path.join(ROOT, "benchmark", *parts)


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 10 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        got = [x["name"] for x in BENCH[kind]]
        assert len(got) == len(set(got))
    metric_names = [m["name"] for m in BENCH["end_to_end"]
                    + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_end_to_end():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        allowed = {"name", "unit", "better", "bound", "source", "workloads"}
        assert set(m) <= allowed
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"][0]
    assert "workloads" not in setup


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_and_metrics(cell):
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    assert os.path.exists(bench_file("configs", f"{w['config']}.json"))
    with open(bench_file("traffic", f"{w['traffic']}.json")) as f:
        mix = json.load(f)
    assert os.path.exists(bench_file("drivers", f"{mix['driver']}.py"))
    assert os.path.exists(bench_file("limits", f"{cell}.json"))
    e2e = harness.cell_metrics(BENCH, cell, False)
    per_layer = harness.cell_metrics(BENCH, cell, True)
    assert len(e2e) >= 2 and len(per_layer) >= 1
    assert any(m["name"] != "setup_s" for m in e2e)
    for m in e2e + per_layer:
        assert os.path.exists(harness.module_path("metrics", m["name"]))
    e2e_names = {m["name"] for m in e2e}
    for m in per_layer:
        assert m["moves"] in e2e_names


def test_per_layer():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_is_the_published_recipe(config):
    """Every number of the published recipe, as it is run (`reduced` is
    empty), and the sizes assumed beside them."""
    entry = {c["name"]: c for c in BENCH["configs"]}[config]
    assert entry["file"] == f"benchmark/configs/{config}.json"
    assert entry["reduced"] == []
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, PUBLISHED[config])) as f:
        published = json.load(f)
    for section in ("train", "data", "model"):
        assert cfg[section] == published[section], section
    assert cfg["source"] == entry["source"]
    assert {"num_phones", "num_speakers", "noise_scale", "noise_scale_w",
            "length_scale", "frames_per_phone"} <= set(cfg["assumed"])
