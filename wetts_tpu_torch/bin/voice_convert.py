"""Voice conversion: re-speak a waveform as another speaker (port of
wetts_tpu/bin/voice_convert.py; reference SynthesizerTrn.voice_conversion,
models.py:369-376).

The source audio is resampled to the model's rate (`utils/wav.py:
resample_poly`) and cut to whole hops; its posterior input (the linear
spectrogram, or the log-mel under `use_mel_posterior_encoder`,
`train/step.py:compute_spec`) goes through the posterior encoder and the
flow with the source speaker, back through the flow with the target
speaker, and through the decoder. The output is peak-scaled to 0.6 and
written as 16-bit PCM at `cfg.data.sampling_rate`.

    python -m wetts_tpu_torch.bin.voice_convert --cfg config.json \
        --model_dir bundle --phone_table phones.txt \
        --speaker_table speaker.txt --wav in.wav --source_speaker spk0 \
        --target_speaker spk1 --out out.wav

`--model_dir` holds any artifact `cli/model.py:load_model` reads but a
final.onnx, which does not carry the posterior encoder that voice
conversion runs. Runs on the GPU and raises without one; `--device cpu`
asks for the CPU. f32 convolutions run in f32, not in cuDNN's default TF32
(`cli/model.py:exact_f32`).
"""

from __future__ import annotations

import argparse


def get_args(argv=None):
    p = argparse.ArgumentParser(
        description="VITS voice conversion (PyTorch/CUDA)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--model_dir", required=True,
                   help="directory with params.npz or ckpt_<step>.pt")
    p.add_argument("--phone_table", required=True)
    p.add_argument("--speaker_table", required=True)
    p.add_argument("--wav", required=True, help="source waveform")
    p.add_argument("--source_speaker", required=True)
    p.add_argument("--target_speaker", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    import numpy as np
    import torch

    from wetts_tpu_torch.cli.model import exact_f32, load_model
    from wetts_tpu_torch.config import Config
    from wetts_tpu_torch.data.dataset import read_table
    from wetts_tpu_torch.train.step import compute_spec
    from wetts_tpu_torch.utils.device import resolve_device
    from wetts_tpu_torch.utils.wav import read_wav, resample_poly, write_wav

    device = resolve_device(args.device)  # before anything is loaded
    exact_f32()
    cfg = Config.from_json(args.cfg)
    phone2id = read_table(args.phone_table)
    speaker2id = read_table(args.speaker_table)
    cfg.num_phones = max(cfg.num_phones, max(phone2id.values()) + 1)
    cfg.num_speakers = max(cfg.num_speakers, max(speaker2id.values()) + 1)
    model = load_model(args.model_dir, cfg).to(device).eval()

    wav, rate = read_wav(args.wav)
    if wav.ndim > 1:
        wav = wav[0]
    if rate != cfg.data.sampling_rate:
        wav = resample_poly(wav, rate, cfg.data.sampling_rate)
    hop = cfg.data.hop_length
    wav = wav[: (len(wav) // hop) * hop]
    with torch.inference_mode():
        spec = compute_spec(cfg, torch.from_numpy(
            np.ascontiguousarray(wav, np.float32))[None].to(device))
        sids = [torch.tensor([speaker2id[name]], device=device)
                for name in (args.source_speaker, args.target_speaker)]
        audio, _, _ = model.voice_conversion(
            spec, torch.tensor([spec.shape[1]], device=device), *sids,
            generator=torch.Generator(device).manual_seed(0))
    audio = audio[0, :, 0].cpu().numpy()
    peak = max(0.01, float(np.abs(audio).max()))
    write_wav(args.out, audio * 0.6 / peak, cfg.data.sampling_rate)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
