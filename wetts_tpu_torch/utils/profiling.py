"""Per-stage latency accounting (the port's copy of wetts_tpu's StageTimes),
and the CUDA-event timers of `chip_smoke.py` and the probes in `tools/`.

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
from typing import Callable, Deque, Dict, Iterator

import torch

# a sleep of some 30 ms at the H100's clocks, behind which `device_ms` queues
# its launches
SLEEP_CYCLES = 50_000_000

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


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs back to back between CUDA
    events, after a warm-up: the device's time, or the host's where the host
    takes longer to launch than the device to run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn: Callable[[], object], reps: int = 50) -> float:
    """Device milliseconds per fn() with the host's launch time hidden: the
    launches queue behind a sleep, then run back to back between the
    events. Raises if the host took longer to queue them than half the
    sleep (the sleep might not have hidden it)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_s = time.perf_counter() - t0
    if queued > 0.5 * sleep_s:
        raise RuntimeError(f"the host took {queued} s to queue {reps} calls "
                           f"behind a sleep of {sleep_s} s")
    return start.elapsed_time(end) / reps


def host_us(fn: Callable[[], object], reps: int = 50) -> float:
    """Host microseconds to make one fn() call, the device kept busy."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return us
