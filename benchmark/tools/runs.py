"""Run cells several times, each run a process of its own, and print the
spread of every metric: for each set of seeds, the median and the distance
between the first and third quartiles (statistics.quantiles, n=4) as a
share of the median.

    python3 benchmark/tools/runs.py --workload <cell> --seeds 11,12,13
        --seconds 30 [--trace 1] [--sets 2] [--out runs.jsonl]

Each set runs the same seeds in turn. Every result line (with the end of
standard error where a run fails) goes to --out.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True)
    out = {"workload": workload, "seed": seed, "trace": trace,
           "rc": proc.returncode, "wall_s": time.perf_counter() - t0}
    lines = proc.stdout.strip().splitlines()
    try:
        out["result"] = json.loads(lines[-1])
    except (IndexError, ValueError):
        out["result"] = None
    if proc.returncode != 0 or out["result"] is None:
        out["stderr"] = proc.stderr[-4000:]
    else:
        out["stderr_tail"] = proc.stderr.strip().splitlines()[-6:]
    return out


def spread(values):
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q = statistics.quantiles(values, n=4)
    return med, (q[2] - q[0]) / abs(med)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", action="append", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--out", default="")
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    records = []
    for workload in args.workload:
        for k in range(args.sets):
            rows = [one(workload, s, args.seconds, args.trace)
                    for s in seeds]
            records += rows
            for r in rows:
                res = r["result"] or {}
                print(json.dumps({"set": k, "seed": r["seed"], "rc": r["rc"],
                                  "wall_s": round(r["wall_s"], 1),
                                  "correct": res.get("correct"),
                                  "metrics": {m: v["value"] for m, v in
                                              res.get("metrics", {}).items()},
                                  "checked": res.get("checked")}))
                if "stderr" in r:
                    print(r["stderr"][-2500:])
            metrics = {}
            for r in rows:
                for m, v in ((r["result"] or {}).get("metrics") or {}).items():
                    metrics.setdefault(m, []).append(v["value"])
            for m, vs in sorted(metrics.items()):
                med, sp = spread(vs)
                print(f"{workload} set {k} {m}: n={len(vs)} median={med!r} "
                      f"iqr/median={sp:.4f} values={vs}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.join(ROOT, args.out)),
                    exist_ok=True)
        with open(os.path.join(ROOT, args.out), "a") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
