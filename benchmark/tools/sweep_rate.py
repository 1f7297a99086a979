"""Find the open-loop cell's knee: run its window at each offered rate in
one process and print, per rate, the completed requests per second, the
latency p50 and p95, the batcher's mean batch, and the backlog's growth
(the median latency of the window's last quarter of requests over its
second quarter's). The knee is the highest rate whose backlog does not
grow; the cell's traffic file then takes 0.8 of it.

    python3 benchmark/tools/sweep_rate.py --config vits_v1
        --traffic serve_open --rates 40,60,80,100,120,140 --seconds 20
        --seed 7

The configuration and the open-loop mix are named by their files
(benchmark/configs/, benchmark/traffic/), so a cell can be swept before
BENCHMARK.json holds it.
"""

import argparse
import gc
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args()
    from benchmark.run import pin_caches

    pin_caches()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from benchmark import harness
    from benchmark.calls import free_program
    from benchmark.system import load_config
    from benchmark.traffic import load_mix, percentile

    name = f"{args.config}.{args.traffic}"
    cell = {"name": name, "config": args.config, "traffic": args.traffic,
            "chips": 1}
    cfg, mix = load_config(args.config), load_mix(args.traffic)
    driver = harness.load_module("drivers", mix["driver"])
    for rate in [float(r) for r in args.rates.split(",")]:
        run = harness.Run(name=name, cell=cell, cfg=cfg,
                          mix=dict(mix, rate_per_s=rate), seed=args.seed,
                          seconds=args.seconds, trace=False,
                          device=torch.device("cuda"),
                          t_start=time.perf_counter())
        state = driver.setup(run)
        harness.settle(run.device)
        driver.window(run, state)
        gc.unfreeze()
        lat = run.record["latency_ms"]
        q = max(1, len(lat) // 4)
        quarters = [statistics.median(lat[i * q:(i + 1) * q])
                    for i in range(4)]
        ok = [x for x in lat if x != float("inf")]
        print(json.dumps({
            "rate_per_s": rate, "attempted": run.record["attempted"],
            "failed": run.record["failed"],
            "completed_per_s": len(ok) / args.seconds,
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "batch_mean": statistics.mean(run.record["batch_sizes"]),
            "quarter_p50_ms": quarters,
            "backlog_growth": quarters[3] / quarters[1],
            "sender_late_ms": run.record["sender_late_ms"]}), flush=True)
        free_program(state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
