"""Console entry: `python -m wetts_tpu_torch.cli.tts --text ... --wav out.wav`
(port of wetts_tpu/cli/tts.py).

Behavioral parity target: wetts/cli/tts.py:30-36 + setup.py:13-15 console
script — synthesize `--text` to `--wav` with optional `--speaker`. Runs on
the GPU and raises without one; `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="TTS synthesis (PyTorch/CUDA)")
    parser.add_argument("--text", required=True, help="text to synthesize")
    parser.add_argument("--wav", required=True, help="output wav path")
    parser.add_argument("--model-dir", default=None,
                        help="model bundle directory (see cli/model.py); "
                             "when omitted, the pretrained multilingual "
                             "bundle is fetched from the hub "
                             "(wetts/cli/tts.py:30-36 zero-config path)")
    parser.add_argument("--speaker", default=None, help="speaker name")
    parser.add_argument("--precision", default="f32",
                        choices=["f32", "bf16", "int8"],
                        help="decoder serving precision: f32 exact, bf16 "
                             "half, int8 dynamically-quantized convs (the "
                             "analog of the reference's optional uint8 "
                             "quantized export, export_onnx.py --quant)")
    parser.add_argument("--device", default=None,
                        help="cuda (default; raises without a GPU) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from wetts_tpu_torch.cli.model import Model
    from wetts_tpu_torch.utils.device import resolve_device
    from wetts_tpu_torch.utils.wav import write_wav

    device = resolve_device(args.device)  # before anything is fetched
    model_dir = args.model_dir
    if model_dir is None:
        from wetts_tpu_torch.cli.hub import get_default_model_dir

        model_dir = get_default_model_dir()
    model = Model(model_dir, precision=args.precision, device=device)
    audio = model.synthesis(args.text, args.speaker)
    write_wav(args.wav, audio, model.sample_rate)
    print(f"wrote {args.wav} ({audio.shape[0] / model.sample_rate:.2f}s)")


if __name__ == "__main__":
    main()
