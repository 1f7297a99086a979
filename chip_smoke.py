#!/usr/bin/env python3
"""Drive the PyTorch port (`wetts_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
1. print the card's name and power limit; build every CUDA kernel of the
   port from `wetts_tpu_torch/csrc/` (one nvcc per source, all at once);
2. hold kernel K1 (`mrf_stage`) against its plain PyTorch version at the
   four VITS-base MRF stage shapes of a batch of 4 at the 352-frame decode
   bucket, f32 with TF32 off, and time both; time the model's three
   synthesis stages at the same bucket;
3. synthesize 48 batches of 4 raw-phone requests of about 4 s of audio
   each with `SynthesisEngine` on the GPU at the full width of
   examples/baker/configs/v1.json (seeded random weights, a synthetic phone
   table, 4 speakers), and report all the audio over all the wall time;
4. serve 3 HTTP requests through `TtsServer` on 127.0.0.1 and shut it down;
5. check the GPU's audio against the plain path on the CPU on a small input.
Phases 3 and 4 are the main path: K1's launch count is zeroed just before
them and read just after. The last two lines are the kernels JSON and the
device JSON. Imports nothing of JAX; needs a CUDA device.
"""

from __future__ import annotations

import base64
import io
import json
import os
import subprocess
import sys
import time
import urllib.parse
import urllib.request
import wave

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "examples", "baker", "configs", "v1.json")
KERNELS = ("mrf_stage",)
# H100 SXM published peaks at the 700 W limit (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BATCH, FRAME_BUCKET = 4, 352
N_PHONES, N_SPEAKERS, SEED = 64, 4, 1234
SYNTH_BATCHES = 48  # of BATCH ~4 s requests: a window of a few seconds


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` runs, after a warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def stage_cost(b: int, t: int, c: int, kernel_sizes, dilations, kind):
    """(flops, bytes) one MRF stage must do and move: 2*C*C*k per conv tap
    per sample; input and output read and written once, weights once."""
    from wetts_tpu_torch.models.mrf import convs_per_branch

    taps = sum(k * convs_per_branch(kind, d)
               for k, d in zip(kernel_sizes, dilations))
    n_convs = sum(convs_per_branch(kind, d) for d in dilations)
    flops = 2 * c * c * taps * b * t
    nbytes = 4 * (2 * b * t * c + c * c * taps + c * n_convs)
    return flops, nbytes


def phase_kernels(model, gen_cfg):
    """K1 against its plain version at the v1 stage shapes."""
    from wetts_tpu_torch.models.mrf import mrf_stage, mrf_stage_reference

    kind = gen_cfg.resblock
    ks = tuple(gen_cfg.resblock_kernel_sizes)
    ds = tuple(tuple(d) for d in gen_cfg.resblock_dilation_sizes)
    rows, t = [], FRAME_BUCKET
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for i, u in enumerate(gen_cfg.upsample_rates):
        t *= u
        c = gen_cfg.upsample_initial_channel // 2 ** (i + 1)
        stage = model.dec.stage_convs(i)
        h = torch.randn(BATCH, t, c, device="cuda", generator=gen)
        got = mrf_stage(h, stage, kind, ks, ds)
        want = mrf_stage_reference(h, stage, kind, ks, ds)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        check(bool(torch.isfinite(got).all()), f"stage {i}: non-finite")
        # f32 sums of up to C*k = 2816 products, taken in another order
        check(err <= 1e-4 * scale,
              f"stage {i}: max |kernel - plain| {err} > 1e-4 * {scale}")
        ms = cuda_ms(lambda: mrf_stage(h, stage, kind, ks, ds), 5)
        plain_ms = cuda_ms(lambda: mrf_stage_reference(h, stage, kind, ks, ds),
                           3)
        flops, nbytes = stage_cost(BATCH, t, c, ks, ds, kind)
        bound_ms = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
        row = {"stage": i, "B": BATCH, "T": t, "C": c, "max_abs_err": err,
               "max_abs_plain": scale, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "gflop": flops / 1e9,
               "tflops": flops / ms / 1e9}
        print("K1 stage " + json.dumps(row))
        rows.append(row)
    return rows


def phase_model_stages(model, rows):
    """Device time of the three synthesis stages for a batch of 4 at the
    64-phone text bucket and the 352-frame decode bucket, and K1's share of
    the decode (its four stages from phase 2, at the same shapes)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randint(1, N_PHONES, (BATCH, 64), device="cuda", generator=gen)
    xl = torch.full((BATCH,), 64, device="cuda")
    sid = torch.arange(BATCH, device="cuda") % N_SPEAKERS
    with torch.inference_mode():
        z_p, _, _, _, g = model.encode_prior(x, xl, sid, max_frames=768,
                                             generator=gen)
        z_p = z_p[:, :FRAME_BUCKET]
        mask = torch.ones(BATCH, FRAME_BUCKET, 1, device="cuda")
        z = model.flow_reverse(z_p, mask, g)
        out = {
            "encode_prior_ms": cuda_ms(lambda: model.encode_prior(
                x, xl, sid, max_frames=768, generator=gen), 3),
            "flow_reverse_ms": cuda_ms(
                lambda: model.flow_reverse(z_p, mask, g), 3),
            "decode_ms": cuda_ms(lambda: model.decode(z, g), 3),
        }
    out["k1_share_of_decode"] = sum(r["ms"] for r in rows) / out["decode_ms"]
    return out


@torch.no_grad()
def random_init_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded random weights at the scale of torch's default init, for runs
    without a checkpoint: every tensor U(-1/sqrt(fan_in), +), with fan_in =
    numel / shape[0]; LayerNorm gamma 1 and beta 0; weight-norm g = ||v||,
    then folded. Nothing is left at zero, so no path is hidden."""
    from wetts_tpu_torch.models.layers import WeightNormed

    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("gamma", "beta", "weight_g"):
            continue
        fan_in = p.numel() // p.shape[0] if p.ndim > 1 else p.numel()
        bound = fan_in ** -0.5
        p.copy_(torch.rand(p.shape, generator=gen) * 2 * bound - bound)
    for module in model.modules():
        if isinstance(module, WeightNormed) and hasattr(module, "weight_v"):
            v = module.weight_v
            module.weight_g.copy_(torch.sqrt(
                (v * v).sum(dim=tuple(range(1, v.ndim)), keepdim=True)))
            module.fold_()
    return model


def build_engine(cfg):
    from wetts_tpu_torch.models.synthesizer import Synthesizer
    from wetts_tpu_torch.serving.engine import SynthesisEngine

    model = random_init_(Synthesizer(cfg), SEED)
    phone2id = {"sil": 0, **{f"p{i}": i for i in range(1, N_PHONES)}}
    speakers = {f"spk{i}": i for i in range(N_SPEAKERS)}
    # random weights predict about one frame per phone; length_scale 5
    # brings durations near real speech's (~6 frames of 11.6 ms per phone)
    engine = SynthesisEngine(cfg, model, phone2id, speakers, seed=SEED,
                             length_scale=5.0)
    check(engine.device == torch.device("cuda"), "engine not on cuda")
    return engine


def phrase(rng, n: int) -> str:
    return " ".join(f"p{int(i)}" for i in rng.integers(1, N_PHONES, n))


def utterance_batches(engine, rng, n_batches: int):
    """Batches of BATCH raw-phone requests of 55-63 phones (with the `sil`
    head at most 64, the 64-phone text bucket): about 4 s of audio each at
    the engine's length_scale; the decode buckets they reach are reported."""
    return [([engine.text_to_phone_ids(phrase(rng, int(n)))
              for n in rng.integers(55, 64, BATCH)],
             [engine.speaker_id(f"spk{i}") for i in range(BATCH)])
            for _ in range(n_batches)]


def phase_synthesis(engine, batches):
    """Batches of ~4 s requests through SynthesisEngine on the GPU, one
    after another; the rate is all audio over all the wall time."""
    from wetts_tpu_torch.serving.engine import TEXT_BUCKETS, FRAMES_PER_TEXT

    audios, batch_ms, buckets = [], [], {}
    t0 = time.perf_counter()
    for ids, sids in batches:
        tb = time.perf_counter()
        out = engine.synthesize_ids_batch(ids, sids)
        batch_ms.append(1e3 * (time.perf_counter() - tb))
        audios += out
        fb = engine._frame_bucket(max(a.size for a in out) // engine.hop,
                                  TEXT_BUCKETS[1] * FRAMES_PER_TEXT)
        buckets[fb] = buckets.get(fb, 0) + 1
    wall = time.perf_counter() - t0
    for a in audios:
        check(a.ndim == 1 and a.size > 0 and a.size % engine.hop == 0,
              f"audio shape {a.shape}")
        check(bool(np.isfinite(a).all()) and float(np.abs(a).max()) > 0,
              "audio not finite or all zero")
    seconds = sum(a.size for a in audios) / engine.sample_rate
    return {"requests": len(audios), "batch": BATCH, "audio_s": seconds,
            "mean_request_audio_s": seconds / len(audios), "wall_s": wall,
            "audio_s_per_s": seconds / wall,
            "batch_ms_p50": float(np.median(batch_ms)),
            "batch_ms_min": min(batch_ms), "batch_ms_max": max(batch_ms),
            "frame_buckets": {str(k): v for k, v in sorted(buckets.items())}}


def phase_serving(engine, rng):
    """3 requests through TtsServer on 127.0.0.1, then shut it down."""
    from wetts_tpu_torch.serving.server import TtsServer

    server = TtsServer(engine, host="127.0.0.1", port=0)
    server.start_background()
    try:
        for i in range(3):
            query = urllib.parse.urlencode(
                {"text": phrase(rng, 15 + 5 * i), "name": f"spk{i}"})
            url = f"http://127.0.0.1:{server.port}/?{query}"
            with urllib.request.urlopen(url, timeout=120) as resp:
                check(resp.status == 200, f"HTTP status {resp.status}")
                body = json.loads(resp.read())
            check(body["status"] == "ok", f"server said {body}")
            wav = base64.b64decode(body["audio"])
            check(wav[:4] == b"RIFF", "response is not a RIFF WAV")
            with wave.open(io.BytesIO(wav)) as w:
                check(w.getframerate() == engine.sample_rate,
                      f"WAV rate {w.getframerate()}")
                check(w.getnframes() > 0, "empty WAV")
    finally:
        server.shutdown()


def phase_reference(engine):
    """The GPU path against the plain path on the CPU, same weights and
    input, deterministic scales (0, 1, 0); f32 on both sides, TF32 off."""
    import copy

    x = torch.arange(1, 13)[None] % (N_PHONES - 1) + 1
    xl = torch.tensor([12])
    sid = torch.tensor([1])
    cpu_model = copy.deepcopy(engine.model).cpu()
    with torch.inference_mode():
        want, wl, _ = cpu_model.infer(x, xl, sid, 0.0, 1.0, 0.0, 64)
        got, gl, _ = engine.model.infer(x.cuda(), xl.cuda(), sid.cuda(),
                                        0.0, 1.0, 0.0, 64)
    check(torch.equal(gl.cpu(), wl), f"y_lengths {gl.tolist()} vs {wl.tolist()}")
    err = (got.cpu() - want).abs().max().item()
    check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
          "GPU audio not finite or misshapen")
    # f32 on both sides; 2e-4 is the CPU parity tests' audio tolerance
    check(err <= 2e-4, f"GPU vs CPU audio max diff {err}")
    return {"y_len": gl.tolist(), "max_abs_err": err}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from wetts_tpu_torch.config import Config
    from wetts_tpu_torch.models.mrf import convs_per_branch, mrf_stage
    from wetts_tpu_torch.utils import cuda_build

    # f32 throughout: cuDNN convolutions would otherwise run in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    for name in KERNELS:
        cuda_build.build(name)
    print(f"built {list(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        for line in cuda_build.compiler_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    cfg = Config.from_json(CONFIG)
    cfg.num_phones, cfg.num_speakers = N_PHONES, N_SPEAKERS
    engine = build_engine(cfg)
    rows = phase_kernels(engine.model, cfg.model)
    print("model_stages " + json.dumps(phase_model_stages(engine.model, rows)))

    rng = np.random.default_rng(SEED)
    # warm-up (cuDNN plans, allocator), then the main path's requests
    engine.synthesize(phrase(rng, 10))
    for ids, sids in utterance_batches(engine, rng, 2):
        engine.synthesize_ids_batch(ids, sids)
    batches = utterance_batches(engine, rng, SYNTH_BATCHES)
    mrf_stage.launches = 0
    engine.stage_times.reset()
    synth = phase_synthesis(engine, batches)
    phase_serving(engine, rng)
    launches = mrf_stage.launches
    report = engine.stage_times.report()
    n_decode = report["decode"]["n"]
    per_decode = sum(convs_per_branch(cfg.model.resblock, d)
                     for d in cfg.model.resblock_dilation_sizes
                     ) * len(cfg.model.upsample_rates)
    check(launches > 0, "K1 was not launched on the main path")
    check(launches == per_decode * n_decode,
          f"K1 launches {launches} != {per_decode} x {n_decode} decodes")
    print("synthesis " + json.dumps(synth))
    print("stage_times " + json.dumps(
        {k: {"n": v["n"], "mean_ms": v["mean_ms"], "p50_ms": v["p50_ms"]}
         for k, v in report.items()}))
    print("reference " + json.dumps(phase_reference(engine)))

    kernels = [{
        "name": "mrf_stage", "route": "cuda",
        "source": "wetts_tpu_torch/csrc/mrf_stage.cu",
        "replaces": "wetts_tpu/models/mrf_pallas.py:172",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "operations",
        "library_ms": None,
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
