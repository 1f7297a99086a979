"""Per-stage latency accounting (the port's copy of wetts_tpu's StageTimes),
and the CUDA-event timers of `chip_smoke.py` and the probes in `tools/`.

The reference's observability is ad hoc: per-stage wall-clock prints inside
SynthesizerTrn.infer (wetts/vits/model/models.py:242-279) and a C++ Timer
used by the HTTP server (runtime/core/utils/timer.h). `StageTimes`
accumulates named host-clock durations so p50/p99 can be reported. On the
GPU a stage's time is only the device's if the stage ends in a device sync;
the engine's batch stages do. A `device_stage` is timed on the device
instead, between two CUDA events, with no sync of its own. Named counters
are reported beside the stages. While torch.profiler records, each stage is
also the user annotation `wetts.<name>` on the profiler's timeline, which
the device's operations share, so a trace can say how long the device
worked and sat idle inside each stage.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from typing import Callable, Deque, Dict, Iterator, List, Tuple

import torch
from torch.autograd import profiler as autograd_profiler

# a sleep of some 30 ms at the H100's clocks, behind which `device_ms` queues
# its launches
SLEEP_CYCLES = 50_000_000

# Per-stage history bound: a long-running server records stage times per
# request; an unbounded list would leak memory proportional to request
# count. 4096 observations keep p99 meaningful while capping memory.
MAX_OBSERVATIONS = 4096


class StageTimes:
    """Named per-stage duration accumulator: the count and total of every
    observation since `reset()`, the percentiles over the last `maxlen`;
    and named counters, the count and sum of what was counted since
    `reset()`."""

    def __init__(self, maxlen: int = MAX_OBSERVATIONS):
        self._times: Dict[str, Deque[float]] = defaultdict(
            lambda: deque(maxlen=maxlen))
        self._n: Dict[str, int] = defaultdict(int)
        self._total: Dict[str, float] = defaultdict(float)
        self._count_n: Dict[str, int] = defaultdict(int)
        self._count: Dict[str, int] = defaultdict(int)
        # (stage, start event, end event) of device stages not yet added
        self._pending: List[Tuple[str, torch.cuda.Event,
                                  torch.cuda.Event]] = []

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        # while nothing records, the span costs one check of this flag
        span = None
        if autograd_profiler._is_profiler_enabled:
            span = torch.profiler.record_function(f"wetts.{name}")
            span.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)
            if span is not None:
                span.__exit__(None, None, None)

    @contextlib.contextmanager
    def device_stage(self, name: str, device: torch.device
                     ) -> Iterator[None]:
        """A stage timed on the device where `device` is a CUDA device: an
        event recorded on the current stream where it opens and another
        where it closes. The stage adds no sync: their elapsed time is
        added once the closing event has completed, as a later sync of the
        caller's makes it (`report()` and the next device stage look).
        Elsewhere a host-clock `stage`."""
        if device.type != "cuda":
            with self.stage(name):
                yield
            return
        self._add_completed()
        span = None
        if autograd_profiler._is_profiler_enabled:
            span = torch.profiler.record_function(f"wetts.{name}")
            span.__enter__()
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        try:
            yield
        finally:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self._pending.append((name, start, end))
            if span is not None:
                span.__exit__(None, None, None)

    def _add_completed(self) -> None:
        """Add each pending device stage whose closing event has
        completed."""
        waiting = []
        for name, start, end in self._pending:
            if end.query():
                self.add(name, 1e-3 * start.elapsed_time(end))
            else:
                waiting.append((name, start, end))
        self._pending = waiting

    def count(self, name: str, value: int) -> None:
        """Add `value` to the counter `name` (a name no stage has)."""
        self._count_n[name] += 1
        self._count[name] += value

    def add(self, name: str, seconds: float) -> None:
        self._times[name].append(seconds)
        self._n[name] += 1
        self._total[name] += seconds

    def reset(self) -> None:
        self._times.clear()
        self._n.clear()
        self._total.clear()
        self._count_n.clear()
        self._count.clear()
        self._pending = []

    def percentile(self, name: str, q: float) -> float:
        xs = sorted(self._times.get(name, ()))
        if not xs:
            return float("nan")
        idx = min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1))))
        return xs[idx]

    def report(self) -> Dict[str, Dict[str, float]]:
        """Per stage its count `n`, `total_s`, `mean_ms`, `p50_ms` and
        `p99_ms`; per counter `n` (how often it was counted) and `count`
        (the sum counted), with the stage keys' times at 0, so that a
        reader of every entry's times reads counters as stages that took
        none."""
        self._add_completed()
        out = {}
        for name in self._times:
            n, total = self._n[name], self._total[name]
            out[name] = {
                "n": n,
                "total_s": total,
                "mean_ms": 1e3 * total / n,
                "p50_ms": 1e3 * self.percentile(name, 50),
                "p99_ms": 1e3 * self.percentile(name, 99),
            }
        for name, n in self._count_n.items():
            out[name] = {"n": n, "count": self._count[name], "total_s": 0.0,
                         "mean_ms": 0.0, "p50_ms": 0.0, "p99_ms": 0.0}
        return out

    def summary(self) -> str:
        return "  ".join(
            f"{k}: {v['count']}(x{v['n']})" if "count" in v
            else f"{k}: {v['mean_ms']:.1f}ms(x{v['n']})"
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
