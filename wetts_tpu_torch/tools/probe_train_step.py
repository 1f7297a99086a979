"""Probe of one training step on the card, f32 against bf16.

    python -m wetts_tpu_torch.tools.probe_train_step [--config CONFIG]
        [--wd] [--cudnn-benchmark]

At the full width of a model config (examples/baker/configs/
vits2_vocos_v1.json by default), batch 32 of 8192-sample segments cut from
900-frame utterances with 192 phones, 64 phones and 4 speakers, weights
from `init_weights_` at a fixed seed and a seeded noise batch, TF32 off:
for each precision (f32, then `bf16_run`), in turns f32, bf16, bf16, f32,
each after one untimed step of its own:
- `split`: the step's phases on the device between CUDA events
  (`train_step`'s marks), and `host_ms`, the step ending in a
  synchronise;
- from a torch.profiler trace of one step: `device_ms`, the sum of its
  kernels' device time (annotated ranges left out; kernels on one stream
  do not overlap), `launches`, and `top`, the kernels of the most device
  time with their share of it (`profiled: false` where the trace holds no
  device events); then per precision `busy_share`, the profiled step's
  `device_ms` over the unprofiled step's host time (the profiler slows
  the host).
`--wd` adds the WavLM discriminator behind a WavLM at the default geometry
(wavlm-base-plus's) with torch's default init from the seed;
`--cudnn-benchmark` lets cuDNN time its algorithms (the port does not).
One JSON line per turn; needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.wavlm import (
    WavLMConfig,
    WavLMModel,
    make_slm_feature_fn,
)
from wetts_tpu_torch.train.state import GANTrainState
from wetts_tpu_torch.train.step import build_models, init_weights_, train_step

BATCH, FRAMES, T_TEXT, N_PHONES, N_SPEAKERS, SEED = 32, 900, 192, 64, 4, 1234
TOP = 12
VITS2_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                            "..", "examples", "baker", "configs",
                            "vits2_vocos_v1.json")
PHASES = ("g_forward", "d_update", "dur_d_update", "wd_update", "g_update")


def make_state(path: str, bf16: bool, wd: bool):
    cfg = Config.from_json(path)
    cfg.num_phones, cfg.num_speakers = N_PHONES, N_SPEAKERS
    cfg.train.bf16_run, cfg.model.use_wd = bf16, wd
    nets = build_models(cfg)
    init_weights_(nets[0], nets[1], torch.Generator().manual_seed(SEED),
                  *nets[2:])
    nets = [None if n is None else n.cuda() for n in nets]
    return cfg, GANTrainState.create(cfg, *nets)


def make_batch(cfg) -> dict:
    gen = torch.Generator().manual_seed(SEED)
    text = torch.randint(T_TEXT // 2, T_TEXT + 1, (BATCH,), generator=gen)
    text[0] = T_TEXT
    batch = {
        "phone_ids": torch.randint(1, N_PHONES, (BATCH, T_TEXT),
                                   generator=gen),
        "text_lengths": text,
        "wav": 0.1 * torch.randn(BATCH, FRAMES * cfg.data.hop_length,
                                 generator=gen),
        "spec_lengths": torch.full((BATCH,), FRAMES),
        "sid": torch.randint(0, N_SPEAKERS, (BATCH,), generator=gen)}
    return {k: v.cuda() for k, v in batch.items()}


def slm_features(sampling_rate: int, slm_sr: int):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = WavLMModel(WavLMConfig())
        conv = model.encoder.pos_conv_embed.conv
        with torch.no_grad():
            conv.weight_v.copy_(torch.randn(conv.weight_v.shape)
                                / conv.weight_v[0].numel() ** 0.5)
            conv.weight_g.copy_(conv.weight_v.square().sum(
                (0, 1), keepdim=True).sqrt())
    return make_slm_feature_fn(model.cuda(), sampling_rate, slm_sr)


def one_step(cfg, state, batch, slm, profile: bool) -> dict:
    events = {"start": torch.cuda.Event(enable_timing=True)}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    gen = torch.Generator(batch["wav"].device).manual_seed(SEED)
    torch.cuda.synchronize()
    prof = None
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t0 = time.perf_counter()
    events["start"].record()
    train_step(cfg, state, batch, gen, mark=mark, slm_feature_fn=slm)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    if prof is not None:
        prof.__exit__(None, None, None)
    names = ["start"] + [p for p in PHASES if p in events]
    split = {f"{b}_ms": events[a].elapsed_time(events[b])
             for a, b in zip(names[:-1], names[1:])}
    out = {"host_ms": host_ms, "split": split}
    if prof is not None:
        out.update(kernel_table(prof, host_ms))
    return out


def kernel_table(prof, wall_ms: float) -> dict:
    """The device's busy share and its top kernels from a profile."""
    # the trace also lists annotated ranges (the optimiser's step) among
    # the device's events; they span kernels counted on their own
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    total_us = sum(e.self_device_time_total for e in kernels)
    if not total_us:
        return {"profiled": False}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]
    return {"profiled": True, "device_ms": total_us / 1e3,
            "busy_share_profiled": total_us / 1e3 / wall_ms,
            "kernels": len(kernels),
            "launches": sum(e.count for e in kernels),
            "top": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                     "share": e.self_device_time_total / total_us,
                     "count": e.count} for e in top]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default=VITS2_CONFIG)
    parser.add_argument("--wd", action="store_true")
    parser.add_argument("--cudnn-benchmark", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_train_step needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    runs = {}
    for bf16 in (False, True):
        cfg, state = make_state(args.config, bf16, args.wd)
        slm = (slm_features(cfg.data.sampling_rate, cfg.model.slm_sr)
               if args.wd else None)
        batch = make_batch(cfg)
        one_step(cfg, state, batch, slm, profile=False)  # warm-up
        runs[bf16] = (cfg, state, batch, slm)
    done = {}
    for turn, bf16 in enumerate((False, True, True, False)):
        torch.cuda.reset_peak_memory_stats()
        res = one_step(*runs[bf16], profile=turn in (1, 3))
        done.setdefault(bf16, []).append(res)
        print(json.dumps({
            "turn": turn, "precision": "bf16" if bf16 else "f32",
            "wd": args.wd, "cudnn_benchmark": args.cudnn_benchmark,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(), **res,
            "card": torch.cuda.get_device_name(0)}))
    # the profiler slows the host: the busy share is the profiled step's
    # device time over the unprofiled step's host time
    for bf16, (plain, profiled) in sorted(
            (k, sorted(v, key=lambda r: "top" in r)) for k, v in done.items()):
        if profiled.get("profiled"):
            print(json.dumps({
                "precision": "bf16" if bf16 else "f32", "wd": args.wd,
                "cudnn_benchmark": args.cudnn_benchmark,
                "host_ms": plain["host_ms"],
                "device_ms": profiled["device_ms"],
                "busy_share": profiled["device_ms"] / plain["host_ms"]}))


if __name__ == "__main__":
    main()
