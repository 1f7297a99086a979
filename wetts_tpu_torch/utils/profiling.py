"""Per-stage latency accounting (the port's copy of wetts_tpu's StageTimes).

The reference's observability is ad hoc: per-stage wall-clock prints inside
SynthesizerTrn.infer (wetts/vits/model/models.py:242-279) and a C++ Timer
used by the HTTP server (runtime/core/utils/timer.h). `StageTimes`
accumulates named host-clock durations so p50/p99 can be reported. On the
GPU a stage's time is only the device's if the stage ends in a device sync;
the engine's stages do.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from typing import Deque, Dict, Iterator

# Per-stage history bound: a long-running server records stage times per
# request; an unbounded list would leak memory proportional to request
# count. 4096 observations keep p99 meaningful while capping memory.
MAX_OBSERVATIONS = 4096


class StageTimes:
    """Named per-stage duration accumulator (all observations, bounded)."""

    def __init__(self, maxlen: int = MAX_OBSERVATIONS):
        self._times: Dict[str, Deque[float]] = defaultdict(
            lambda: deque(maxlen=maxlen))

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._times[name].append(seconds)

    def reset(self) -> None:
        self._times.clear()

    def percentile(self, name: str, q: float) -> float:
        xs = sorted(self._times.get(name, ()))
        if not xs:
            return float("nan")
        idx = min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1))))
        return xs[idx]

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._times.items():
            out[name] = {
                "n": len(xs),
                "total_s": sum(xs),
                "mean_ms": 1e3 * sum(xs) / len(xs),
                "p50_ms": 1e3 * self.percentile(name, 50),
                "p99_ms": 1e3 * self.percentile(name, 99),
            }
        return out

    def summary(self) -> str:
        return "  ".join(
            f"{k}: {v['mean_ms']:.1f}ms(x{v['n']})"
            for k, v in sorted(self.report().items()))
