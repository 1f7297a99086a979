"""What every cell shares: the cell's files found by name, the device
checks, the measured window's tracer, the reading of the trace, the
per-layer metrics' readers, and the result line.

A driver (`benchmark/drivers/<name>.py`, named by the traffic mix) gives
four functions: `setup(run)` builds the system, draws the schedule and
warms it; `window(run, state)` drives the timed entry for `run.seconds`,
untraced, and records what it produced and what the program's spans and
counters read into `run.record`; `trace(run, state)` drives the same
traffic for TRACE_SLICE_S more under torch.profiler and leaves the trace in
`run.trace_data`; `check(run, state)` frees the program and compares what
the window produced with the reference, returning the compared numbers by
name. Each metric (`benchmark/metrics/<name>.py`, or the file of the name's
part before its first dot, which serves every cell kind) gives
`read(run)`, a number or None where there is nothing to read.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from benchmark import ROOT

# the traced slice that follows a traced run's window, all of it under the
# profiler: enough calls for steady shares, few enough events to read
# within the run's limit
TRACE_SLICE_S = 8.0
# the top-level names of modules that no run may hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "wetts_tpu")
# how long past the window's close the harness waits for late answers
LATE_WAIT_S = 60.0


def module_path(kind: str, name: str) -> str:
    """benchmark/<kind>/<name>.py, or where there is none the file of the
    name's part before its first dot (`k1_roofline.batch` is read by
    `k1_roofline.py`)."""
    path = os.path.join(ROOT, "benchmark", kind, f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(ROOT, "benchmark", kind,
                            f"{name.split('.')[0]}.py")
    return path


def load_module(kind: str, name: str):
    """The module of module_path(kind, name)."""
    path = module_path(kind, name)
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf8") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics, or with
    a trace its per-layer ones (those listing the cell, or without a list
    those whose end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


@dataclass
class Run:
    """One run of one cell: its files, its arguments, and what the window
    recorded for the metrics to read."""

    name: str
    cell: dict
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    # what the cell's traffic driver recorded in the window (requests,
    # streams, stage times, batch sizes), and the decoder's input shapes in
    # the traced slice
    record: Dict[str, Any] = field(default_factory=dict)
    # the traced slice: device intervals, spans, its wall length
    trace_data: Optional["TraceData"] = None


@dataclass
class TraceData:
    window_s: float
    # (name, start_ns, end_ns) of every operation on the device
    device_ops: List[Tuple[str, int, int]]
    # (name, start_ns, end_ns) of the benchmark's own spans
    spans: List[Tuple[str, int, int]]

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        busy, end = 0, None
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-9

    def op_seconds(self, pattern) -> float:
        return 1e-9 * sum(e - s for n, s, e in self.device_ops
                          if pattern.search(n))

    def breakdown(self) -> dict:
        """The device operations that took most time, and the device's idle
        time between operations summed by the innermost benchmark span open
        at the middle of each gap."""
        by_op: Dict[str, int] = {}
        for n, s, e in self.device_ops:
            by_op[n] = by_op.get(n, 0) + (e - s)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps: Dict[str, int] = {}
        end = None
        spans = sorted(self.spans, key=lambda sp: sp[1])
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            if end is not None and s > end:
                mid = (s + end) // 2
                label = "no benchmark span"
                for name, a, b in spans:
                    if a > mid:
                        break
                    if b >= mid:
                        label = name  # later-starting spans are inner
                gaps[label] = gaps.get(label, 0) + (s - end)
            end = e if end is None else max(end, e)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:200], v * 1e-9] for n, v in ops],
                "idle_gaps": [[n, v * 1e-9] for n, v in idle]}


class Tracer:
    """torch.profiler over a traced run's slice, started and stopped by the
    driver where no call is in flight; `span` names the benchmark's calls
    into the program in the trace, and is nothing outside it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.prof = None
        self.t0 = self.t1 = None

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(f"bench.{name}")

    def start(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:  # the spans of the batcher's and the clients' threads too
            from torch.profiler import _ExperimentalConfig

            self.prof = profile(activities=acts,
                                experimental_config=_ExperimentalConfig(
                                    profile_all_threads=True))
        except (ImportError, TypeError):
            self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.active = False
        self.prof.__exit__(None, None, None)

    def data(self) -> Optional[TraceData]:
        if self.prof is None:
            return None
        ops, spans = [], []
        for ev in self.prof.profiler.kineto_results.events():
            name = ev.name()
            if ev.is_user_annotation():
                # a span, and its copy on the device's timeline, is no
                # device operation
                if (name.startswith("bench.")
                        and ev.device_type().name != "CUDA"):
                    spans.append((name[len("bench."):], ev.start_ns(),
                                  ev.end_ns()))
            elif ev.device_type().name == "CUDA":
                ops.append((name, ev.start_ns(), ev.end_ns()))
        return TraceData(self.t1 - self.t0, ops, spans)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def device_info(device, count: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def settle(device) -> None:
    """End set-up: wait for the device, collect set-up's garbage and freeze
    what is left (the model, the schedule) out of the cyclic collector's
    view, so that no full collection over set-up's objects pauses the
    window's threads."""
    import gc

    sync(device)
    gc.collect()
    gc.freeze()


def sync(device) -> None:
    """Wait for the device where there is one."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
