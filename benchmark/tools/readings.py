"""The two readings each limit of `correct` is set from, for one cell, in
one process: for every seed, a short window at the cell's own load, then

- the program's numbers against the reference (what a run compares), and
- with `--control`, the control's: the reference computed with TF32 on,
  the nearest precision below the configurations' float32, put in the
  program's place on the same calls (the same rows, speakers and noise).

    python3 benchmark/tools/readings.py --workload vits_v1.batch
        --seeds 1,2,3 --seconds 5 [--control]

One JSON line per seed and side.
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


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args()
    from benchmark.run import pin_caches

    pin_caches()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from benchmark import harness
    from benchmark.system import load_config
    from benchmark.traffic import load_mix

    bench = harness.load_benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg, mix = load_config(cell["config"]), load_mix(cell["traffic"])
    driver = harness.load_module("drivers", mix["driver"])
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = harness.Run(name=args.workload, cell=cell, cfg=cfg, mix=mix,
                          seed=seed, seconds=args.seconds, trace=False,
                          device=torch.device("cuda"),
                          t_start=time.perf_counter())
        state = driver.setup(run)
        harness.settle(run.device)
        driver.window(run, state)
        gc.unfreeze()
        program = driver.check(run, state)
        print(json.dumps({"seed": seed, "side": "program", **program}),
              flush=True)
        if args.control:
            control = driver.check(run, state, control=True)
            print(json.dumps({"seed": seed, "side": "control", **control}),
                  flush=True)
        del state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
