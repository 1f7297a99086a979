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
3. synthesize 16 batches of 4 raw-phone requests of about 4 s of audio
   each with `SynthesisEngine` on the GPU at the full width of
   examples/baker/configs/v1.json (seeded random weights, a synthetic phone
   table, 4 speakers), and report all the audio over all the wall time;
4. serve 3 HTTP requests through `TtsServer` on 127.0.0.1 and shut it down;
5. check the GPU's audio against the plain path on the CPU on a small input;
6. hold kernel K2 (`maximum_path`, monotonic alignment search) exactly equal
   to its plain PyTorch version at the shapes v1 training produces, and time
   both;
7. train: write a seeded synthetic corpus (64 noise-like utterances of
   3.5-11 s, 4 speakers) to a temporary directory, build `Trainer` from
   v1.json as it stands (batch 32, segment 8192, f32) with seeded random
   weights, take 1 warm-up and 6 timed steps, save, resume in a second
   `Trainer` and take one more; check metrics, moved parameters and the
   first step's alignment, and split one step's device time by phase;
8. check one training step on the GPU against the CPU at a small size.
Phases 3 and 4 are the serving main path and phase 7 the training main path:
each kernel's launch count is zeroed just before its path and read just
after (K1 must not move while training, K2 launches once per step). The
last two lines are the kernels JSON and the device JSON. Imports nothing of
JAX; needs a CUDA device.
"""

from __future__ import annotations

import base64
import concurrent.futures
import contextlib
import copy
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.parse
import urllib.request
import wave

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "examples", "baker", "configs", "v1.json")
KERNELS = ("mrf_stage", "mas")
# H100 SXM published peaks at the 700 W limit (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BATCH, FRAME_BUCKET = 4, 352
N_PHONES, N_SPEAKERS, SEED = 64, 4, 1234
SYNTH_BATCHES = 16  # of BATCH ~4 s requests: a window of a few seconds
# K2 at the [B, T_spec, T_text] shapes v1 training produces (batch 32, frame
# buckets up to 1000, text padded to a multiple of 16), a 1x1 and a square
MAS_SHAPES = ((32, 400, 64), (32, 700, 128), (32, 1000, 208), (2, 1, 1),
              (4, 48, 48))
TRAIN_UTTERANCES, TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS = 64, 1, 6


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


@torch.no_grad()
def phase_kernels(model, gen_cfg):
    """K1 against its plain version at the v1 stage shapes (inference: K1
    has no backward and refuses inputs that record a gradient)."""
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
    then folded. Nothing is left at zero, so no path is hidden. The
    posterior encoder draws last, so that a synthesizer's other weights (and
    with them the durations the serving phases see) are those this function
    gave before the model held one."""
    from wetts_tpu_torch.models.layers import WeightNormed

    gen = torch.Generator().manual_seed(seed)
    for name, p in sorted(model.named_parameters(),
                          key=lambda item: item[0].startswith("enc_q.")):
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


def mas_inputs(b: int, t_spec: int, t_text: int, gen: torch.Generator):
    """Scores and a ragged mask on the GPU: spec lengths in
    [max(t_text, t_spec / 2), t_spec], text lengths in [t_text / 2, t_text]
    (never above the spec length), one utterance at full size."""
    neg_cent = torch.randn(b, t_spec, t_text, device="cuda", generator=gen) * 3
    t_ys = torch.randint(max(t_text, t_spec // 2), t_spec + 1, (b,),
                         device="cuda", generator=gen)
    t_xs = torch.minimum(torch.randint(max(t_text // 2, 1), t_text + 1, (b,),
                                       device="cuda", generator=gen), t_ys)
    t_ys[0], t_xs[0] = t_spec, t_text
    mask = ((torch.arange(t_spec, device="cuda")[None, :, None]
             < t_ys[:, None, None])
            & (torch.arange(t_text, device="cuda")[None, None, :]
               < t_xs[:, None, None])).float()
    return neg_cent, mask


def mas_bound_ms(mask: torch.Tensor) -> float:
    """The least time the card could take for MAS on these inputs: the
    larger of bytes over the memory rate (the valid cells of neg_cent read
    once, the path written once, 4 bytes each) and operations over the f32
    rate (one add and one max per valid cell). Bytes win by far."""
    valid = float(mask.sum().item())
    nbytes = 4.0 * (valid + mask.numel())
    return 1e3 * max(nbytes / PEAK_BYTES, 2.0 * valid / PEAK_F32_FLOPS)


def phase_mas_kernel():
    """K2 against its plain version at the v1 training shapes: exactly equal;
    both timed with CUDA events (the plain version, a Python loop of T_spec
    steps, once)."""
    from wetts_tpu_torch.ops.mas import (
        _launch,
        _prepare,
        maximum_path,
        maximum_path_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for b, t_spec, t_text in MAS_SHAPES:
        neg_cent, mask = mas_inputs(b, t_spec, t_text, gen)
        got = maximum_path(neg_cent, mask)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = maximum_path_reference(neg_cent, mask)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        n_diff = int((got != want).sum().item())
        check(n_diff == 0, f"K2 {b}x{t_spec}x{t_text}: {n_diff} cells differ "
                           f"from the plain version")
        check(bool((got.sum(-1) == mask[:, :, 0]).all()),
              "K2: not one text position per valid frame")
        ms = cuda_ms(lambda: maximum_path(neg_cent, mask), 20)
        # the kernel's launch alone, on prepared inputs: `ms` above also
        # holds the wrapper's plain PyTorch part (lengths, the -1e9 fill,
        # the final `* mask`), a dozen small launches that the host may
        # enqueue more slowly than the card runs them
        masked, _, t_xs, t_ys = _prepare(neg_cent, mask)
        kernel_ms = cuda_ms(lambda: _launch(masked, t_xs, t_ys), 20)
        row = {"B": b, "T_spec": t_spec, "T_text": t_text,
               "max_abs_err": float((got - want).abs().max().item()),
               "ms": ms, "plain_ms": plain_ms,
               "bound_ms": mas_bound_ms(mask), "bound_by": "bytes",
               "kernel_ms": kernel_ms,
               "us_per_row": 1e3 * kernel_ms / t_spec}
        print("K2 shape " + json.dumps(row))
        rows.append(row)
    return rows


def write_corpus(root: str, rng) -> tuple:
    """A seeded synthetic corpus: noise-like 22.05 kHz wavs of 3.5-11 s (so
    that frame buckets from 400 up to 1000 occur), phones from the 64-phone
    table at about one per 5 frames, 4 speakers. Returns the paths of the
    manifest, the phone table and the speaker table."""
    from wetts_tpu_torch.utils.wav import write_wav

    os.makedirs(os.path.join(root, "wavs"))
    lines = []
    for i in range(TRAIN_UTTERANCES):
        seconds = 3.5 + 7.5 * i / (TRAIN_UTTERANCES - 1)
        n = int(seconds * 22050)
        wav = (0.1 * rng.standard_normal(n)).astype(np.float32)
        path = os.path.join(root, "wavs", f"u{i}.wav")
        write_wav(path, wav, 22050)
        n_phones = min(190, max(10, n // 256 // 5))
        lines.append(f"{path}|spk{i % N_SPEAKERS}|{phrase(rng, n_phones)}")
    paths = [os.path.join(root, name)
             for name in ("train.txt", "phones.txt", "speakers.txt")]
    with open(paths[0], "w") as f:
        f.write("\n".join(lines))
    with open(paths[1], "w") as f:
        f.write("sil 0\n" + "\n".join(f"p{i} {i}"
                                        for i in range(1, N_PHONES)))
    with open(paths[2], "w") as f:
        f.write("\n".join(f"spk{i} {i}" for i in range(N_SPEAKERS)))
    return tuple(paths)


@contextlib.contextmanager
def observed_training(record: dict):
    """While active, notes for every training step its frame bucket and the
    host time at which it had finished on the device, and keeps the first
    step's MAS inputs. The trainer and the synthesizer look both functions up
    by name in their own modules, which is where they are wrapped."""
    from wetts_tpu_torch.models import synthesizer
    from wetts_tpu_torch.train import trainer

    real_mas, real_step = synthesizer.maximum_path, trainer.train_step

    def mas(neg_cent, mask):
        record.setdefault("mas_inputs", (neg_cent, mask))
        if "mas_events" in record:
            record["mas_events"][0].record()
        path = real_mas(neg_cent, mask)
        if "mas_events" in record:
            record["mas_events"][1].record()
        return path

    def step(cfg, state, batch, generator=None, mark=None):
        metrics = real_step(cfg, state, batch, generator, mark)
        torch.cuda.synchronize()
        record.setdefault("step_end", []).append(time.perf_counter())
        record.setdefault("buckets", []).append(
            batch["wav"].shape[1] // cfg.data.hop_length)
        return metrics

    synthesizer.maximum_path, trainer.train_step = mas, step
    try:
        yield
    finally:
        synthesizer.maximum_path, trainer.train_step = real_mas, real_step


WATCHED_PARAMS = {
    "G": ("dec.conv_pre.weight", "dec.ups.0.weight_g", "dec.ups.0.weight_v",
          "dec.resblocks.0.convs1.0.weight_g",
          "dec.resblocks.11.convs2.2.weight_v",
          "flow.flows.0.enc.in_layers.0.weight_g",
          "flow.flows.0.enc.in_layers.0.weight_v",
          "enc_q.enc.in_layers.15.weight_v", "enc_p.emb.weight",
          "dp.flows.1.proj.weight", "emb_g.weight"),
    "D": ("discriminators.0.convs.0.weight_g",
          "discriminators.0.conv_post.weight_v",
          "discriminators.5.convs.4.weight_v"),
}


def phase_training(cfg):
    """The training main path at v1's full width through `Trainer`."""
    from wetts_tpu_torch.models.mrf import mrf_stage
    from wetts_tpu_torch.ops.mas import maximum_path, maximum_path_reference
    from wetts_tpu_torch.train.step import train_step
    from wetts_tpu_torch.train.trainer import Trainer

    cfg = copy.deepcopy(cfg)
    cfg.train.log_interval = 1  # every step's metrics reach metrics.jsonl
    n_first = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS
    record = {}
    with tempfile.TemporaryDirectory(prefix="wetts_smoke_") as root:
        manifest, phones, speakers = write_corpus(
            root, np.random.default_rng(SEED))
        model_dir = os.path.join(root, "exp")
        trainer = Trainer(copy.deepcopy(cfg), model_dir, manifest, phones,
                          speakers)
        check(trainer.device.type == "cuda", "trainer not on cuda")
        check(trainer.start_step == 0 and len(trainer.dataset)
              == TRAIN_UTTERANCES, "corpus or start step")
        nets = {"G": trainer.state.net_g, "D": trainer.state.net_d}
        random_init_(nets["G"], SEED)
        random_init_(nets["D"], SEED + 1)
        start = {k: {n: dict(net.named_parameters())[n].detach().clone()
                     for n in WATCHED_PARAMS[k]} for k, net in nets.items()}

        # ---- the main path: counts zeroed just before, read just after ----
        torch.cuda.reset_peak_memory_stats()
        maximum_path.launches = mrf_stage.launches = 0
        with observed_training(record):
            t0 = time.perf_counter()
            check(trainer.train(max_steps=n_first) == n_first, "steps taken")
            t_first = time.perf_counter()
            resumed = Trainer(copy.deepcopy(cfg), model_dir, manifest, phones,
                              speakers)
            check(resumed.start_step == n_first,
                  f"resumed at {resumed.start_step}, not {n_first}")
            check(resumed.train(max_steps=n_first + 1) == n_first + 1,
                  "the resumed trainer's step")
        launches = {"mas": maximum_path.launches, "mrf": mrf_stage.launches}
        peak_bytes = torch.cuda.max_memory_allocated()
        n_steps = n_first + 1
        check(launches["mas"] == n_steps,
              f"K2 launches {launches['mas']} != {n_steps} steps")
        check(launches["mrf"] == 0,
              f"K1 launched {launches['mrf']} times while training")

        with open(os.path.join(model_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        check([m["step"] for m in metrics] == list(range(1, n_steps + 1)),
              "metrics.jsonl steps")
        for m in metrics:
            for key, value in m.items():
                check(bool(np.isfinite(value)), f"step {m['step']} {key}")
        for key in ("loss/g_total", "loss/disc"):
            values = [m[key] for m in metrics]
            check(len(set(values)) == len(values), f"{key} repeats: {values}")
        for k, net in nets.items():
            params = dict(net.named_parameters())
            for name, before in start[k].items():
                check(not torch.equal(params[name].detach(), before),
                      f"{k} parameter {name} did not move")
        resumed_params = dict(resumed.state.net_g.named_parameters())
        check(not torch.equal(resumed_params["dec.conv_pre.weight"],
                              dict(nets["G"].named_parameters())
                              ["dec.conv_pre.weight"]),
              "the resumed trainer's step changed nothing")

        # ---- the first step's own alignment: K2 against the plain version
        neg_cent, mask = record["mas_inputs"]
        check(torch.equal(maximum_path(neg_cent, mask),
                          maximum_path_reference(neg_cent, mask)),
              "K2 differs from the plain version on the first step's inputs")

        # ---- one more step, split by phase with CUDA events ----
        names = ("start", "g_forward", "d_update", "g_update")
        events = {n: torch.cuda.Event(enable_timing=True) for n in names}
        record["mas_events"] = [torch.cuda.Event(enable_timing=True)
                                for _ in range(2)]
        batch = resumed._feed(next(iter(resumed.batcher(1))))
        with observed_training(record):
            events["start"].record()
            train_step(resumed.cfg, resumed.state, batch, resumed.generator,
                       mark=lambda name: events[name].record())
        torch.cuda.synchronize()
        split = {f"{b}_ms": events[a].elapsed_time(events[b])
                 for a, b in zip(names[:-1], names[1:])}
        split["mas_ms"] = record["mas_events"][0].elapsed_time(
            record["mas_events"][1])
        split["frames"] = batch["wav"].shape[1] // cfg.data.hop_length
        split["T_text"] = batch["phone_ids"].shape[1]

    ends = record["step_end"]
    step_ms = [1e3 * (b - a) for a, b in zip([t0] + ends[:n_first - 1],
                                             ends[:n_first])]
    timed = step_ms[TRAIN_WARMUP_STEPS:]
    return {
        "steps": n_steps, "batch": cfg.train.batch_size,
        "segment_size": cfg.train.segment_size,
        "frame_buckets": record["buckets"][:n_steps],
        "T_text_first_step": neg_cent.shape[2],
        "warmup_step_ms": step_ms[:TRAIN_WARMUP_STEPS],
        "step_ms_p50": float(np.median(timed)), "step_ms_min": min(timed),
        "step_ms_max": max(timed),
        "steps_per_s": len(timed) / (sum(timed) / 1e3),
        "save_s": t_first - ends[n_first - 1],
        "peak_memory_bytes": peak_bytes,
        "loss_g_total": [m["loss/g_total"] for m in metrics],
        "loss_disc": [m["loss/disc"] for m in metrics],
        "split_of_one_step": split,
    }, launches


def phase_train_reference():
    """One training step on the GPU (K2 in the forward, the differentiable
    MRF route in the decoder) against the CPU at a small size: the same
    seeded weights, every draw replaced by a fixed pattern and dropout off.
    The alignment must be exactly equal and every loss within rel 1e-3 (f32
    sums taken in another order)."""
    from wetts_tpu_torch.config import Config
    from wetts_tpu_torch.models.mrf import mrf_stage
    from wetts_tpu_torch.ops import random
    from wetts_tpu_torch.ops.mas import maximum_path
    from wetts_tpu_torch.train.state import GANTrainState
    from wetts_tpu_torch.train.step import build_models, train_step

    cfg = Config.from_dict({
        "train": {"segment_size": 256},
        "data": {"filter_length": 64, "hop_length": 16, "win_length": 64,
                 "n_mel_channels": 20},
        "model": {"inter_channels": 32, "hidden_channels": 32,
                  "filter_channels": 64, "n_layers": 2,
                  "resblock_kernel_sizes": [3, 5],
                  "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]],
                  "upsample_rates": [4, 4], "upsample_initial_channel": 64,
                  "upsample_kernel_sizes": [8, 8], "gin_channels": 16},
        "num_phones": 24, "num_speakers": 3})
    net_g, net_d = build_models(cfg)
    random_init_(net_g, SEED)
    random_init_(net_d, SEED + 1)
    gen = torch.Generator().manual_seed(SEED)
    batch = {"phone_ids": torch.randint(1, 24, (2, 9), generator=gen),
             "text_lengths": torch.tensor([9, 7]),
             "wav": torch.randn(2, 24 * 16, generator=gen) * 0.3,
             "spec_lengths": torch.tensor([24, 21]),
             "sid": torch.tensor([0, 1])}

    def pattern(shape, device, dtype=torch.float32, generator=None):
        n = torch.Size(shape).numel()
        return (0.4 * torch.sin(0.7 * torch.arange(n, dtype=torch.float32)
                                + 0.37)).reshape(tuple(shape)).to(device,
                                                                  dtype)

    def constant(shape, device, dtype=torch.float32, generator=None):
        return torch.full(tuple(shape), 0.37, device=device, dtype=dtype)

    def run(device):
        g, d = copy.deepcopy(net_g).to(device), copy.deepcopy(net_d).to(device)
        attn = []
        handle = g.register_forward_hook(
            lambda module, args, out: attn.append(out["attn"].cpu()))
        metrics = train_step(cfg, GANTrainState.create(cfg, g, d),
                             {k: v.to(device) for k, v in batch.items()})
        handle.remove()
        return {k: float(v) for k, v in metrics.items()}, attn[0]

    saved = random.normal, random.uniform, random.dropout
    random.normal, random.uniform = pattern, constant
    random.dropout = lambda x, p, training, generator=None: x
    try:
        want, want_attn = run("cpu")
        before = maximum_path.launches, mrf_stage.launches
        got, got_attn = run("cuda")
    finally:
        random.normal, random.uniform, random.dropout = saved
    check(maximum_path.launches - before[0] == 1, "K2 launches in one step")
    check(mrf_stage.launches == before[1], "K1 launched while training")
    check(torch.equal(got_attn, want_attn), "GPU and CPU alignments differ")
    worst = 0.0
    for key, value in want.items():
        rel = abs(got[key] - value) / max(abs(value), 1e-12)
        check(np.isfinite(got[key]) and rel <= 1e-3,
              f"{key}: GPU {got[key]} vs CPU {value}")
        worst = max(worst, rel)
    return {"max_rel_err": worst, "loss_g_total": got["loss/g_total"],
            "attn_frames": int(got_attn.sum().item())}


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
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(cuda_build.build, KERNELS))  # one nvcc each, together
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

    mas_rows = phase_mas_kernel()
    del engine  # the serving model's memory goes back before training
    torch.cuda.empty_cache()
    training, train_launches = phase_training(cfg)
    print("training " + json.dumps(training))
    print("train_reference " + json.dumps(phase_train_reference()))
    v1_rows = [r for r in mas_rows if r["B"] == 32]

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
    }, {
        # ms, plain_ms and bound_ms: sums over the three v1 training shapes
        "name": "mas", "route": "cuda",
        "source": "wetts_tpu_torch/csrc/mas.cu",
        "replaces": "wetts_tpu/ops/mas_pallas.py:81",
        "launches": train_launches["mas"],
        "max_abs_err": max(r["max_abs_err"] for r in mas_rows),
        "ms": sum(r["ms"] for r in v1_rows),
        "plain_ms": sum(r["plain_ms"] for r in v1_rows),
        "bound_ms": sum(r["bound_ms"] for r in v1_rows),
        "bound_by": "bytes",
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
