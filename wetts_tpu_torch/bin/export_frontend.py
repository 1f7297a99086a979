"""Export a deployable frontend bundle, with numerics verification (port of
wetts_tpu/bin/export_frontend.py; reference
wetts/frontend/export_onnx.py:55-113).

The bundle is a directory {config.json, params.npz, vocab.txt, lexicon/},
the one `cli/model.py:_load_frontend` of either package reads. `--bf16`
stores the parameters as bfloat16 (a uint16 view, `utils/params_io.py`),
the analog of the reference's uint8 dynamic quantization; `--verify`
compares the softmax posteriors of the written bundle with the source
parameters by cosine similarity on random token ids and asserts at least
0.95 (bf16) or 0.9999 (f32). Runs on the GPU and raises without one;
`--device cpu` asks for the CPU.

    python -m wetts_tpu_torch.bin.export_frontend --model_dir exp/frontend \\
        --vocab vocab.txt --lexicon_dir lexicon --out_dir bundle/frontend \\
        --bf16 --verify
"""

from __future__ import annotations

import argparse
import os
import shutil


def get_args(argv=None):
    p = argparse.ArgumentParser(description="export frontend bundle")
    p.add_argument("--model_dir", required=True,
                   help="training dir with config.json + params.npz")
    p.add_argument("--vocab", required=True)
    p.add_argument("--lexicon_dir", default=None,
                   help="dir with polyphone.txt/pinyin_dict.txt/lexicon.txt")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--bf16", action="store_true",
                   help="store params as bfloat16 (the uint8-dynamic-"
                        "quantization analog; reference export_onnx.py:100)")
    p.add_argument("--verify", action="store_true",
                   help="cosine-similarity check vs source params "
                        "(reference verify_export, export_onnx.py:93-112)")
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def cosine_verify(model_a, model_b, vocab_size: int, device, seed: int = 0,
                  n: int = 4, t: int = 48) -> float:
    """Min cosine similarity between the two models' posteriors on `n`
    random id rows of length `t` (numpy seed)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    worst = 1.0
    for _ in range(n):
        ids = torch.from_numpy(rng.integers(1, vocab_size, (1, t))).to(device)
        mask = torch.ones_like(ids)
        outs = []
        for m in (model_a, model_b):
            with torch.no_grad():
                phone, prosody = m(ids, mask)
            outs.append((torch.softmax(phone, -1), torch.softmax(prosody, -1)))
        for a, b in zip(*outs):
            a = a.double().flatten()
            b = b.double().flatten()
            worst = min(worst, float(a @ b / (a.norm() * b.norm())))
    return worst


def main(argv=None):
    args = get_args(argv)
    import json

    import torch

    from wetts_tpu_torch.cli.model import load_frontend_model
    from wetts_tpu_torch.utils.device import resolve_device
    from wetts_tpu_torch.utils.params_io import (
        load_params_npz,
        save_params_npz,
    )

    device = resolve_device(args.device)
    with open(os.path.join(args.model_dir, "config.json")) as f:
        mc = json.load(f)
    params = load_params_npz(os.path.join(args.model_dir, "params.npz"))
    out_params = params
    if args.bf16:
        def cast(node):
            if isinstance(node, dict):
                return {k: cast(v) for k, v in node.items()}
            t = torch.from_numpy(node)
            return t.to(torch.bfloat16) if t.is_floating_point() else t

        out_params = cast(params)

    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "config.json"), "w") as f:
        json.dump(mc, f, indent=2)
    save_params_npz(os.path.join(args.out_dir, "params.npz"), out_params)
    shutil.copyfile(args.vocab, os.path.join(args.out_dir, "vocab.txt"))
    if args.lexicon_dir:
        dst = os.path.join(args.out_dir, "lexicon")
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        shutil.copytree(args.lexicon_dir, dst)

    if args.verify:
        source = load_frontend_model(args.model_dir).to(device)
        written = load_frontend_model(args.out_dir).to(device)
        cos = cosine_verify(source, written, mc["bert"]["vocab_size"],
                            device)
        print(f"verify: min cosine similarity = {cos:.6f}")
        assert cos > (0.95 if args.bf16 else 0.9999), cos
    print(f"exported frontend bundle to {args.out_dir}")


if __name__ == "__main__":
    main()
