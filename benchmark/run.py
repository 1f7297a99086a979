"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout that holds the port (`wetts_tpu_torch`) and a
CUDA device. Set-up (imports, weights, engine, warm-up) is timed from this
file's first line to the window's start. With `--trace 0` the line holds
the cell's end-to-end metrics. With `--trace 1` the same untraced window is
followed by a slice of harness.TRACE_SLICE_S seconds of the same traffic
under torch.profiler, and the line holds the per-layer metrics (those read
from the program's spans and counters from the untraced window, those read
from the trace from the slice), `busy_s`, `window_s` and a `breakdown`.
Every run then checks what the window produced against the plain reference
and prints each compared number beside its limit, on standard error and
under the line's last key. The last line of standard output is the JSON
object.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pin_caches() -> None:
    """Every cache of a kernel build or compile at a fixed path in the
    checkout (K1's nvcc library stays in wetts_tpu_torch/_build/), set
    before torch is imported."""
    cache = os.path.join(ROOT, "benchmark", ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")


def execute(name: str, cell: dict, cfg: dict, mix: dict, metrics: list,
            seed: int, seconds: float, trace: bool, device,
            t_start: float, limits: dict) -> dict:
    """One run of a cell: set-up, the window, the metrics, the check.
    Returns the result object (without printing it)."""
    from benchmark import harness

    run = harness.Run(name=name, cell=cell, cfg=cfg, mix=mix, seed=seed,
                      seconds=seconds, trace=trace, device=device,
                      t_start=t_start)
    driver = harness.load_module("drivers", mix["driver"])
    state = driver.setup(run)
    harness.settle(device)
    run.setup_s = time.perf_counter() - t_start
    driver.window(run, state)
    if trace:
        driver.trace(run, state)
    gc.unfreeze()
    dev = harness.device_info(device, cell["chips"])
    out_metrics = {}
    for m in metrics:
        value = harness.load_module("metrics", m["name"]).read(run)
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace and run.trace_data is not None:
        dev["busy_s"] = run.trace_data.busy_s()
        dev["window_s"] = run.trace_data.window_s
    numbers = driver.check(run, state)
    compared = [(k, numbers[k], limits[k]) for k in limits]
    correct = all(v <= lim for _, v, lim in compared)
    attempted = run.record.get("attempted", 0)
    failed = run.record.get("failed", 0)
    result = {"correct": bool(correct and failed == 0),
              "attempted": attempted, "failed": failed,
              "metrics": out_metrics, "device": dev}
    if trace and run.trace_data is not None:
        result["breakdown"] = run.trace_data.breakdown()
    result["power"] = harness.power_limit() if device.type == "cuda" else ""
    result["checked"] = {k: {"value": v, "limit": lim}
                         for k, v, lim in compared}
    result["check_info"] = {k: v for k, v in numbers.items()
                            if k not in limits}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    pin_caches()
    from benchmark import harness

    bench = harness.load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    # the configurations state float32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one intra-op thread: the host's work here is Python and small copies,
    # and idle worker threads would compete with the engine's threads for
    # the host's cores
    torch.set_num_threads(1)
    from benchmark.calls import load_limits
    from benchmark.system import load_config
    from benchmark.traffic import load_mix

    result = execute(
        args.workload, cell, load_config(cell["config"]),
        load_mix(cell["traffic"]),
        harness.cell_metrics(bench, args.workload, bool(args.trace)),
        args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
        T_START, load_limits(args.workload))
    found = harness.forbidden_modules()
    if found:
        print(f"the process holds {found} after the window: no result",
              file=sys.stderr)
        return 3
    for k, v in result["checked"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    checked = result.pop("checked")
    result["checked"] = checked  # the line's last key
    print(json.dumps(result, default=float))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
