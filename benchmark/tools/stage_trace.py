"""A batch cell's traced slice read by engine stage, in one process: the
set-up that a run makes, an untraced window of `--seconds`, then the
harness's slice of harness.TRACE_SLICE_S under torch.profiler, read with
`benchmark/stages.py` from the port's `wetts.<stage>` spans. One JSON line:
the stage readings, the device's idle share of the slice, and the host ms
of a traced call (the benchmark's own `synthesize_ids_batch` spans).

    python3 benchmark/tools/stage_trace.py --workload vits_v1.batch
        --seed 11 --seconds 20

Without the port's spans (a program that has none) the stage readings are
null and the rest stands.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def slice_line(run, state) -> dict:
    """What a batch driver's traced slice reads by stage, once
    `driver.trace(run, state)` has run."""
    from benchmark import stages

    trace = run.trace_data
    spans = stages.program_spans(state["tracer"].prof)
    calls = [e - s for n, s, e in trace.spans
             if n == "synthesize_ids_batch"]
    return {
        "window_calls": len(run.record["calls"]),
        "slice_s": trace.window_s,
        "slice_calls": len(calls),
        "traced_call_ms": 1e-6 * sum(calls) / max(1, len(calls)),
        "device_idle": 100.0 * (1.0 - trace.busy_s() / trace.window_s),
        "stages": stages.readings(trace.device_ops, spans, trace.window_s),
    }


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args()
    from benchmark.run import pin_caches

    pin_caches()
    import torch

    from benchmark import harness
    from benchmark.system import load_config
    from benchmark.traffic import load_mix

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    bench = harness.load_benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg, mix = load_config(cell["config"]), load_mix(cell["traffic"])
    if mix["driver"] != "closed_batch":
        print(f"{args.workload} is no batch cell: its stages' spans hold "
              "other stages' work", file=sys.stderr)
        return 2
    driver = harness.load_module("drivers", mix["driver"])
    device = torch.device("cuda")
    t0 = time.perf_counter()
    run = harness.Run(name=args.workload, cell=cell, cfg=cfg, mix=mix,
                      seed=args.seed, seconds=args.seconds, trace=True,
                      device=device, t_start=t0)
    state = driver.setup(run)
    harness.settle(device)
    setup_s = time.perf_counter() - t0
    driver.window(run, state)
    driver.trace(run, state)
    gc.unfreeze()
    print(json.dumps(dict(
        workload=args.workload, seed=args.seed, setup_s=setup_s,
        device=torch.cuda.get_device_name(0), power=harness.power_limit(),
        **slice_line(run, state))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
