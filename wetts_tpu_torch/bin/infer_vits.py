"""Per-utterance inference from a test manifest, with RTF reporting (port of
wetts_tpu/bin/infer_vits.py; the reference's wetts/vits/inference.py:46-114).

Loads a model and its tables, synthesizes each `wav|speaker|phones` line at
noise_scale 0.667 / noise_scale_w 0.8 / length_scale 1, prints the RTF and
writes int16-scaled wavs (audio * 32767 / max(0.01, |a|max) * 0.6).

    python -m wetts_tpu_torch.bin.infer_vits --cfg config.json \
        --model_dir bundle --phone_table phones.txt \
        --speaker_table speaker.txt --test_file test.txt --outdir out \
        --precision int8

`--model_dir` holds any artifact `cli/model.py:load_params` reads, as the
JAX package's `infer_vits` does: a released `G.pth` / `G_<step>.pth` (the
highest step), a `final.onnx`, a `params.npz` bundle (utils/params_io.py),
or the `ckpt_<step>.pt` files a `Trainer` wrote (the latest is taken).
`--precision` is the decoder's: f32, bf16 (bf16 flow and decoder) or int8
(bf16 flow, int8 decoder convolutions). Runs on the GPU and raises without
one; `--device cpu` asks for the CPU. f32 convolutions run in f32, not in
cuDNN's default TF32 (`cli/model.py:exact_f32`).
"""

from __future__ import annotations

import argparse
import os
import time


def get_args(argv=None):
    p = argparse.ArgumentParser(description="VITS inference (PyTorch/CUDA)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--model_dir", required=True,
                   help="directory with G_*.pth, final.onnx, params.npz or "
                        "ckpt_<step>.pt")
    p.add_argument("--phone_table", required=True)
    p.add_argument("--speaker_table", default=None)
    p.add_argument("--test_file", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--precision", default="f32",
                   choices=["f32", "bf16", "int8"],
                   help="decoder precision (int8 = dynamic-quantized convs)")
    p.add_argument("--noise_scale", type=float, default=0.667)
    p.add_argument("--noise_scale_w", type=float, default=0.8)
    p.add_argument("--length_scale", type=float, default=1.0)
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    import numpy as np

    from wetts_tpu_torch.cli.model import exact_f32, load_model
    from wetts_tpu_torch.config import Config
    from wetts_tpu_torch.data.dataset import read_table
    from wetts_tpu_torch.serving.engine import SynthesisEngine
    from wetts_tpu_torch.utils.device import resolve_device
    from wetts_tpu_torch.utils.wav import write_wav

    device = resolve_device(args.device)  # before anything is loaded
    exact_f32()
    cfg = Config.from_json(args.cfg)
    phone2id = read_table(args.phone_table)
    speaker2id = read_table(args.speaker_table) if args.speaker_table else None
    cfg.num_phones = max(cfg.num_phones, max(phone2id.values()) + 1)
    if speaker2id:
        cfg.num_speakers = max(cfg.num_speakers,
                               max(speaker2id.values()) + 1)
    engine = SynthesisEngine(
        cfg, load_model(args.model_dir, cfg), phone2id, speaker2id,
        noise_scale=args.noise_scale, length_scale=args.length_scale,
        noise_scale_w=args.noise_scale_w, device=device,
        half=args.precision == "bf16", quantize=args.precision == "int8")

    os.makedirs(args.outdir, exist_ok=True)
    sr = cfg.data.sampling_rate
    total_audio_s = 0.0
    total_wall = 0.0
    with open(args.test_file, encoding="utf8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) < 3:
                continue
            wav_path, speaker, phones = parts[0], parts[1], parts[2]
            name = os.path.splitext(os.path.basename(wav_path))[0]
            t0 = time.perf_counter()
            audio = engine.synthesize(phones, speaker)
            dt = time.perf_counter() - t0
            audio_s = len(audio) / sr
            total_audio_s += audio_s
            total_wall += dt
            rtf = dt / max(audio_s, 1e-6)
            print(f"{name}: {audio_s:.2f}s audio in {dt:.3f}s, RTF {rtf:.4f}")
            peak = max(0.01, float(np.abs(audio).max())) if audio.size else 1.0
            write_wav(os.path.join(args.outdir, name + ".wav"),
                      (audio * 0.6 / peak), sr)
    if total_audio_s > 0:
        print(f"TOTAL: {total_audio_s:.1f}s audio, overall RTF "
              f"{total_wall / total_audio_s:.4f} "
              f"({total_audio_s / max(total_wall, 1e-9):.1f}x realtime)")
        print(f"stages: {engine.stage_times.summary()}")


if __name__ == "__main__":
    main()
