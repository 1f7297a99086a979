"""The work that each seed draws in a batch cell, and what it costs, in one
process: for every seed, the set-up that a run makes, then `--calls` calls
of the cell's schedule in window order. One JSON line per seed: the
calibrated length scale; realized frames per phone, over all rows and by
speaker; the decoder's padded frames over the realized ones; the frame
buckets met; host ms per call and per engine stage.

    python3 benchmark/tools/seed_work.py --workload vits2_vocos_v1.batch
        --seeds 1,2,3 --calls 96
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
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--calls", type=int, default=96)
    p.add_argument("--device", default="cuda")
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
    driver = harness.load_module("drivers", mix["driver"])
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.Run(name=args.workload, cell=cell, cfg=cfg, mix=mix,
                          seed=seed, seconds=0.0, trace=False,
                          device=device, t_start=t0)
        state = driver.setup(run)
        harness.settle(device)
        setup_s = time.perf_counter() - t0
        engine, recorder = state["engine"], state["recorder"]
        buckets = []
        hook = engine.model.dec.register_forward_pre_hook(
            lambda _m, a: buckets.append(int(a[0].shape[-1])))
        engine.stage_times.reset()
        recorder.recording = True
        for k in range(args.calls):
            batch = state["batches"][k % len(state["batches"])]
            engine.synthesize_ids_batch([r["ids"] for r in batch],
                                        [r["sid"] for r in batch])
        recorder.recording = False
        hook.remove()
        gc.unfreeze()
        calls, hop = recorder.calls, engine.hop
        frames = [s // hop for c in calls for s in c["samples"]]
        phones = [len(i) for c in calls for i in c["ids"]]
        sids = [s for c in calls for s in c["sids"]]
        per_row = [f / n for f, n in zip(frames, phones)]
        by_spk = {}
        for f, n, s in zip(frames, phones, sids):
            a = by_spk.setdefault(s, [0, 0])
            a[0] += f
            a[1] += n
        padded = sum(b * len(c["ids"]) for b, c in zip(buckets, calls))
        call_ms = [1e3 * (c["t1"] - c["t0"]) for c in calls]
        stages = {k: round(v["mean_ms"], 3)
                  for k, v in engine.stage_times.report().items()}
        print(json.dumps({
            "seed": seed, "setup_s": round(setup_s, 2),
            "length_scale": run.record["length_scale"],
            "frames_per_phone": sum(frames) / sum(phones),
            "row_fpp_min_med_max": [min(per_row), statistics.median(per_row),
                                    max(per_row)],
            "fpp_by_speaker": {s: round(a[0] / a[1], 3)
                               for s, a in sorted(by_spk.items())},
            "padded_over_realized": padded / sum(frames),
            "buckets": {b: buckets.count(b) for b in sorted(set(buckets))},
            "call_ms_med": statistics.median(call_ms),
            "stage_ms": stages,
            "audio_s_per_s": sum(frames) * hop / cfg["data"]["sampling_rate"]
            / (calls[-1]["t1"] - calls[0]["t0"])}), flush=True)
        del state, run, engine, recorder, calls
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
