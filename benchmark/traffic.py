"""The one generator of traffic: it reads a mix's parameters from
`benchmark/traffic/<mix>.json` and draws a schedule from the seed.

Every seed gets the same multiset of sizes and of gaps between arrivals:
the sizes are the quantiles (i + 0.5) / pool of the mix's distribution, the
gaps those of the exponential at the mix's rate. The seed shuffles them,
unless the mix says `"order": "fixed"`: then one shuffle serves every seed,
as a replayed trace would, where the order of the sizes and the gaps sets
the queue's tail. The seed always draws the content (phone ids, speakers,
hanzi). So two seeds ask for the same work, and their runs differ by its
content and, where the order is not fixed, its order.

Distributions (`{"dist": ..., ...}`):
- `lognormal`: `median`, `sigma`, clipped to [`min`, `max`], rounded;
- `uniform`: the integers `min` to `max`, each equally often.
"""

from __future__ import annotations

import json
import math
import os
from statistics import NormalDist
from typing import List

import numpy as np

from benchmark import ROOT


def load_mix(name: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "traffic", f"{name}.json"),
              encoding="utf8") as f:
        return json.load(f)


def order_rng(mix: dict, rng: np.random.Generator) -> np.random.Generator:
    """The generator that orders the mix's sizes and gaps: one fixed
    generator for a mix of fixed order, else the run's."""
    return np.random.default_rng(0) if mix.get("order") == "fixed" else rng


def quantile_sizes(spec: dict, pool: int) -> np.ndarray:
    """The pool's sizes: quantiles of the distribution, as integers."""
    q = (np.arange(pool) + 0.5) / pool
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(p)) for p in q])
        x = np.round(spec["median"] * np.exp(spec["sigma"] * z))
    elif spec["dist"] == "uniform":
        x = np.floor(spec["min"] + q * (spec["max"] - spec["min"] + 1))
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return np.clip(x, spec["min"], spec["max"]).astype(np.int64)


def exponential_gaps(rate: float, n: int) -> np.ndarray:
    """n gaps, the quantiles of the exponential distribution at `rate`."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate


def phone_requests(mix: dict, rng: np.random.Generator, n_phones: int,
                   n_speakers: int) -> List[dict]:
    """`pool` raw-phone requests: ids [sil, ...] of the drawn lengths (the
    `sil` head counted in the length), uniform over the phone table's other
    entries; speakers uniform."""
    lengths = order_rng(mix, rng).permutation(
        quantile_sizes(mix["phones"], mix["pool"]))
    speakers = rng.integers(0, n_speakers, len(lengths))
    return [{"ids": [0] + [int(i) for i in rng.integers(1, n_phones,
                                                        n - 1)],
             "sid": int(s)} for n, s in zip(lengths, speakers)]


def arrival_times(mix: dict, rng: np.random.Generator) -> np.ndarray:
    """Send times in seconds from the window's start, an open loop at
    `rate_per_s`: the pool's exponential gaps, shuffled."""
    gaps = order_rng(mix, rng).permutation(
        exponential_gaps(mix["rate_per_s"], mix["pool"]))
    return np.cumsum(gaps) - gaps[0]


def text_requests(mix: dict, rng: np.random.Generator, hanzi: List[str]
                  ) -> List[str]:
    """`pool` Mandarin texts: a drawn number of clauses, each of a drawn
    number of hanzi of the lexicon with a comma in its middle, ended by 。"""
    order = order_rng(mix, rng)
    n_clauses = order.permutation(quantile_sizes(mix["clauses"],
                                                 mix["pool"]))
    per_clause = order.permutation(quantile_sizes(
        mix["hanzi"], int(n_clauses.sum())))
    texts, k = [], 0
    for n in n_clauses:
        clauses = []
        for m in per_clause[k: k + n]:
            chars = [hanzi[int(i)] for i in rng.integers(0, len(hanzi), m)]
            chars.insert(int(m) // 2, "，")
            clauses.append("".join(chars) + "。")
        k += n
        texts.append("".join(clauses))
    return texts


def percentile(values, q: float) -> float:
    """The q-th percentile by the nearest rank over all values."""
    xs = sorted(values)
    if not xs:
        return math.nan
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]
