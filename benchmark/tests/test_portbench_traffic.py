"""The traffic generator: one seed gives one schedule, the drawn sizes fall
in each mix's stated ranges, and every seed gets the same multiset of sizes
and gaps, in another order. The weights of a seed whose durations spread
wide are drawn again, so that every seed asks for the same frames."""

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.drivers.closed_stream import tables
from benchmark import system
from benchmark.system import sub_seed
from benchmark.tests.tiny import tiny_config

N_PHONES, N_SPEAKERS = 476, 4


def phone_schedule(mix, seed):
    rng = np.random.default_rng(sub_seed(seed, 2))
    reqs = traffic.phone_requests(mix, rng, N_PHONES, N_SPEAKERS)
    due = (traffic.arrival_times(mix, rng) if "rate_per_s" in mix
           else None)
    return reqs, due


@pytest.mark.parametrize("name", ["batch_long", "serve_open"])
def test_phone_mix(name):
    mix = traffic.load_mix(name)
    big = 2 ** 31 + 12345
    a, due_a = phone_schedule(mix, big)
    b, due_b = phone_schedule(mix, big)
    c, due_c = phone_schedule(mix, big + 1)
    assert a == b and (due_a is None or np.array_equal(due_a, due_b))
    assert a != c
    lo, hi = mix["phones"]["min"], mix["phones"]["max"]
    lengths = [len(r["ids"]) for r in a]
    assert min(lengths) >= lo and max(lengths) <= hi
    assert sorted(lengths) == sorted(len(r["ids"]) for r in c)
    median = float(np.median(lengths))
    assert abs(median / mix["phones"]["median"] - 1) < 0.02
    assert all(r["ids"][0] == 0 and 0 < min(r["ids"][1:])
               and max(r["ids"]) < N_PHONES for r in a)
    assert {r["sid"] for r in a} == set(range(N_SPEAKERS))
    if due_a is not None:
        assert due_a[0] == 0 and np.all(np.diff(due_a) > 0)
        gaps_a, gaps_c = np.diff(due_a), np.diff(due_c)
        rate = len(gaps_a) / due_a[-1]
        assert abs(rate / mix["rate_per_s"] - 1) < 0.01
        assert abs(np.median(gaps_a) / np.median(gaps_c) - 1) < 0.01


def test_stream_mix():
    mix = traffic.load_mix("stream_zh4")
    _, _, lexicon = tables()
    hanzi = [w for w in lexicon.words() if len(w) == 1]

    def draw(seed):
        return traffic.text_requests(
            mix, np.random.default_rng(sub_seed(seed, 2)), hanzi)

    a, b, c = draw(99), draw(99), draw(100)
    assert a == b and a != c
    for text in a[:200]:
        clauses = text.split("。")[:-1]
        assert mix["clauses"]["min"] <= len(clauses) <= mix["clauses"]["max"]
        for clause in clauses:
            n = len(clause.replace("，", ""))
            assert mix["hanzi"]["min"] <= n <= mix["hanzi"]["max"]
    counts = sorted(t.count("。") for t in a)
    assert counts == sorted(t.count("。") for t in c)


@pytest.mark.parametrize("spec", [
    {"dist": "lognormal", "median": 100, "sigma": 0.35, "min": 32,
     "max": 190},
    {"dist": "uniform", "min": 2, "max": 8}])
def test_quantile_sizes(spec):
    sizes = traffic.quantile_sizes(spec, 4096)
    assert sizes.min() >= spec["min"] and sizes.max() <= spec["max"]
    if spec["dist"] == "uniform":
        counts = np.bincount(sizes)[spec["min"]:]
        assert counts.max() - counts.min() <= 1


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert traffic.percentile(xs, 95) == 95
    assert traffic.percentile([3.0], 95) == 3.0
    assert traffic.percentile(xs + [float("inf")] * 10, 95) == float("inf")


@pytest.mark.parametrize("wide", [0, 1, 3])
def test_a_wide_draw_is_drawn_again(monkeypatch, wide):
    """Draws whose probe rows spread past `probe_row_spread` are replaced
    by the seed's next weight stream; the first narrow draw is kept."""
    cfg = tiny_config("vits2_vocos_v1")
    streams, calibrate = [], system.calibrate_length_scale
    draw = system.make_weights

    def make_weights(shapes, seed, device, stream=0):
        streams.append(stream)
        return draw(shapes, seed, device, stream)

    def rows(cfg, ref, seed, device, probe=None):
        scale, _ = calibrate(cfg, ref, seed, device, probe)
        spread = 0.8 if len(streams) <= wide else 0.1
        return scale, [5.5 * (1 - spread), 5.5, 5.5 * (1 + spread)]

    monkeypatch.setattr(system, "make_weights", make_weights)
    monkeypatch.setattr(system, "calibrate_length_scale", rows)
    weights, _, _ = system.build_system(cfg, 7, torch.device("cpu"))
    assert streams == [0] + [100 + k for k in range(1, wide + 1)]
    kept = draw({k: v.shape for k, v in weights.items()}, 7,
                torch.device("cpu"), streams[-1])
    assert all(torch.equal(weights[k], kept[k]) for k in weights)
