"""Export a deployable model bundle (port of wetts_tpu/bin/export_bundle.py).

Equivalent of wetts/vits/export_onnx.py:54-189: the reference exports ONNX
graphs (full + streaming encoder/decoder split); the bundle here is a
directory of {config.json, params.npz, phones.txt[, speaker.txt]}, the same
bundle `wetts_tpu.cli.model.Model` and `wetts_tpu_torch.cli.model.Model`
read. Any artifact `cli/model.py:load_params` reads goes in (a G_*.pth, a
final.onnx, a params.npz, the port's Trainer checkpoints). Weight norm is
left as (g, v) — `--fold_weight_norm` collapses it. A file conversion: it
touches no device.

    python -m wetts_tpu_torch.bin.export_bundle --cfg config.json \
        --model_dir exp --phone_table phones.txt \
        --speaker_table speaker.txt --out_dir exp/bundle
"""

from __future__ import annotations

import argparse
import os
import shutil


def fold_weight_norm(params):
    """Pre-normalize {v, g} pairs: v := g * v/||v||, g := ||new v||.

    Keeps the tree structure (models still apply the weight-norm formula,
    which is now the identity on the folded values) while removing any
    numerical drift between g and ||v|| accumulated during training —
    the same effect as the reference's remove_weight_norm at export
    (decoders.py:84-88).

    The port's copy of the JAX package's, but for how a pair's layout is
    told: that one goes by shape and takes an upsample whose kernel size
    equals its input channels (torch layout [I, O, K] with K == I) for a
    conv [K, I, O], so it normalizes that upsample over the wrong axes.
    Here the upsamples are known by their name in the tree (`up_<i>`,
    utils/convert.py:convert_synthesizer's).
    """
    import numpy as np

    def axes_for(name, v):
        if name.startswith("up_"):  # conv-transpose torch layout [I, O, K]
            return (1, 2)
        if v.ndim == 3:  # conv [K, I, O]
            return (0, 1)
        return (0, 1, 2)  # conv2d [Kh, Kw, I, O]

    def fold(node, name=""):
        if isinstance(node, dict):
            if "v" in node and "g" in node:
                v = np.asarray(node["v"], np.float64)
                g = np.asarray(node["g"], np.float64)
                axes = axes_for(name, v)
                norm = np.sqrt((v * v).sum(axis=axes, keepdims=True))
                shape = [1] * v.ndim
                free_axis = [a for a in range(v.ndim) if a not in axes][0]
                shape[free_axis] = g.shape[0]
                folded = v * (g.reshape(shape) / np.maximum(norm, 1e-12))
                new_g = np.sqrt((folded * folded).sum(axis=axes))
                out = {k: fold(x, k) for k, x in node.items()
                       if k not in ("v", "g")}
                out["v"] = folded.astype(np.float32)
                out["g"] = new_g.astype(np.float32)
                return out
            return {k: fold(x, k) for k, x in node.items()}
        return node

    return fold(params)


def get_args(argv=None):
    p = argparse.ArgumentParser(description="export model bundle")
    p.add_argument("--cfg", required=True)
    p.add_argument("--model_dir", required=True)
    p.add_argument("--phone_table", required=True)
    p.add_argument("--speaker_table", default=None)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--fold_weight_norm", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from wetts_tpu_torch.cli.model import load_params
    from wetts_tpu_torch.config import Config
    from wetts_tpu_torch.data.dataset import read_table
    from wetts_tpu_torch.utils.params_io import save_params_npz

    cfg = Config.from_json(args.cfg)
    phone2id = read_table(args.phone_table)
    cfg.num_phones = max(cfg.num_phones, max(phone2id.values()) + 1)
    if args.speaker_table:
        sp = read_table(args.speaker_table)
        cfg.num_speakers = max(cfg.num_speakers, max(sp.values()) + 1)
    params = load_params(args.model_dir, cfg)["params"]
    if args.fold_weight_norm:
        params = fold_weight_norm(params)

    os.makedirs(args.out_dir, exist_ok=True)
    shutil.copyfile(args.cfg, os.path.join(args.out_dir, "config.json"))
    shutil.copyfile(args.phone_table,
                    os.path.join(args.out_dir, "phones.txt"))
    if args.speaker_table:
        shutil.copyfile(args.speaker_table,
                        os.path.join(args.out_dir, "speaker.txt"))
    save_params_npz(os.path.join(args.out_dir, "params.npz"), params)
    print(f"exported bundle to {args.out_dir}")


if __name__ == "__main__":
    main()
