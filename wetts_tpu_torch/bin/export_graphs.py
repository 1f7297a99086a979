"""Export the inference graphs with `torch.export` (the port's twin of
wetts_tpu/bin/export_stablehlo.py, named after its function
`export_graphs`: the port writes `torch.export` programs, not StableHLO).

The reference ships ONNX graphs (wetts/vits/export_onnx.py:54-189: a full
graph and the streaming encoder / decoder split). Each graph here is one
`torch.export` program with the weights inside, saved with
`torch.export.save` and loaded with `torch.export.load(path).module()`:

- encoder_t{T}.pt2 : (x i64[1,T], x_length i64[1], sid i64[1],
                      [noise_dp f32[1,2,T],] noise_z f32[1,C,12*T])
                      -> (z f32[1,12*T,C], y_length i64[1])
  per text bucket T. The noise is an input: a traced graph cannot take a
  generator, and a `torch.randn` inside it would ignore any seed (the JAX
  graph takes `seed: i32[]` and draws inside). `encoder_noise(cfg, seed,
  T)` draws both with `torch.Generator().manual_seed(seed)` in
  `encode_prior`'s order, so `graph(x, x_len, sid, *encoder_noise(cfg,
  seed, T))` equals `encode_infer(..., generator=Generator().manual_seed(
  seed))`. `noise_dp` exists only under the stochastic duration predictor.
- decoder_f{F}.pt2 : (z f32[1,F,C], sid i64[1]) -> audio f32[1,F*hop,1]
  per frame bucket F: the streaming z split of the reference
  (models.py:333-363). A HiFi-GAN decoder's MRF stages are nodes of the
  operator `torch.ops.wetts_tpu_torch.mrf_stage` (`models/mrf.py:
  mrf_stage_op`): on the card the loaded graph launches K1, on the CPU it
  runs the plain version. A consumer imports `wetts_tpu_torch.models.mrf`
  before `torch.export.load`, which registers the operator.
- manifest.json : the JAX manifest's keys (bucket tables, sample rate, hop,
  scales, per graph its inputs, outputs and bytes) with its own `format`.

A graph holds the weights of the modules it runs (the encoder: the text
encoder, duration predictor, flow and speaker table; the decoder: the
decoder and the speaker table), the decoder also K1's packed copies of its
MRF weights.

Buckets, scales and frames_per_text = 12 are the JAX export's. The weights
are any artifact `cli/model.py:load_params` reads. A graph holds the device
it was exported on: the export runs on the card unless given `--device
cpu`.

    python -m wetts_tpu_torch.bin.export_graphs --cfg config.json \\
        --model_dir exp --phone_table phones.txt --out_dir exp/graphs
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from wetts_tpu_torch.models import mrf  # noqa: F401 - registers the op
from wetts_tpu_torch.ops import random

FRAMES_PER_TEXT = 12
FORMAT = ("torch.export ExportedProgram (torch.export.save); import "
          "wetts_tpu_torch.models.mrf before torch.export.load")


def get_args(argv=None):
    p = argparse.ArgumentParser(description="export torch.export graphs")
    p.add_argument("--cfg", required=True)
    p.add_argument("--model_dir", required=True,
                   help="any artifact cli/model.py:load_params reads")
    p.add_argument("--phone_table", required=True)
    p.add_argument("--speaker_table", default=None)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--text_buckets", default="32,64,128",
                   help="comma-separated text-length buckets")
    p.add_argument("--frame_buckets", default="96,192,384",
                   help="comma-separated decoder frame buckets")
    p.add_argument("--noise_scale", type=float, default=0.667)
    p.add_argument("--length_scale", type=float, default=1.0)
    p.add_argument("--noise_scale_w", type=float, default=0.8)
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def encoder_noise(cfg, seed: int, t: int,
                  frames_per_text: int = FRAMES_PER_TEXT,
                  device=None) -> List[torch.Tensor]:
    """The encoder graph's noise inputs for text bucket t: the draws
    `encode_infer` takes from `torch.Generator().manual_seed(seed)`, in
    its order (the duration predictor's [1, 2, t] under `use_sdp`, then the
    prior's [1, C, frames_per_text * t]), on `device`."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(1, cfg.model.inter_channels, frames_per_text * t)]
    if cfg.model.use_sdp:
        shapes.insert(0, (1, 2, t))
    return [torch.randn(s, generator=g).to(device) for s in shapes]


def _part(model, keep: Sequence[str]):
    """A shallow copy of `model` that holds only its submodules `keep`, so
    that a graph carries only the weights it reads."""
    part = copy.copy(model)
    part._modules = {k: v for k, v in model._modules.items() if k in keep}
    return part


class EncoderGraph(nn.Module):
    """(x, x_length, sid, *noise) -> (z, y_length) at fixed scales."""

    def __init__(self, model, scales: Sequence[float], max_frames: int):
        super().__init__()
        self.model = _part(model, ("enc_p", "dp", "flow", "emb_g"))
        self.scales, self.max_frames = scales, max_frames

    def forward(self, x, x_length, sid, *noise):
        with random.supplied(noise):
            z, y_length, *_ = self.model.encode_infer(
                x, x_length, sid, *self.scales, max_frames=self.max_frames)
        return z, y_length


class DecoderGraph(nn.Module):
    """(z, sid) -> audio."""

    def __init__(self, model):
        super().__init__()
        self.model = _part(model, ("dec", "emb_g"))

    def forward(self, z, sid):
        return self.model.decode(z, sid=sid)


def export_graphs(cfg, model, text_buckets: Sequence[int],
                  frame_buckets: Sequence[int],
                  scales: Tuple[float, float, float] = (0.667, 1.0, 0.8),
                  frames_per_text: int = FRAMES_PER_TEXT
                  ) -> Dict[str, Tuple[torch.export.ExportedProgram, Dict]]:
    """{name: (ExportedProgram, io_doc)} for every bucket, on the device of
    `model` (the `Synthesizer` of `cfg`, put in eval mode with its
    gradients turned off).
    One eager decode runs first, so that the decoder's lazily derived
    tensors (K1's packed weights) exist before tracing and enter the graph
    as constants."""
    model.eval().requires_grad_(False)
    dev = next(model.parameters()).device
    c = cfg.model.inter_channels
    sid = torch.zeros(1, dtype=torch.long, device=dev)
    out = {}
    with torch.no_grad():
        for t in text_buckets:
            frames = t * frames_per_text
            noise = encoder_noise(cfg, 0, t, frames_per_text, dev)
            args = (torch.ones(1, t, dtype=torch.long, device=dev),
                    torch.full((1,), t, dtype=torch.long, device=dev), sid,
                    *noise)
            ep = torch.export.export(EncoderGraph(model, scales, frames),
                                     args)
            out[f"encoder_t{t}"] = (ep, {
                "in": ["x i64[1,%d]" % t, "x_length i64[1]", "sid i64[1]"]
                + ["noise_%s f32[%s]" % (name, ",".join(map(str, n.shape)))
                   for name, n in zip(("dp", "z")[-len(noise):], noise)],
                "out": ["z f32[1,%d,%d]" % (frames, c), "y_length i64[1]"],
            })
        for f in frame_buckets:
            z = torch.zeros(1, f, c, device=dev)
            model.decode(z, sid=sid)  # K1's packed weights, eagerly
            ep = torch.export.export(DecoderGraph(model), (z, sid))
            out[f"decoder_f{f}"] = (ep, {
                "in": ["z f32[1,%d,%d]" % (f, c), "sid i64[1]"],
                "out": ["audio f32[1,%d,1]" % (f * model.hop)],
            })
    return out


def write_graphs(graphs, out_dir: str, manifest: Dict) -> Dict:
    """Save every graph as `<name>.pt2` and `manifest.json` beside them;
    returns the manifest with each graph's bytes."""
    os.makedirs(out_dir, exist_ok=True)
    manifest = dict(manifest, format=FORMAT, graphs={})
    for name, (ep, io_doc) in graphs.items():
        path = os.path.join(out_dir, name + ".pt2")
        torch.export.save(ep, path)
        manifest["graphs"][name] = dict(io_doc,
                                        bytes=os.path.getsize(path))
        print(f"wrote {path} ({manifest['graphs'][name]['bytes']} bytes)")
    with open(os.path.join(out_dir, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=2)
    return manifest


def main(argv=None):
    args = get_args(argv)
    from wetts_tpu_torch.cli.model import exact_f32, load_model
    from wetts_tpu_torch.config import Config
    from wetts_tpu_torch.data.dataset import read_table
    from wetts_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    exact_f32()
    cfg = Config.from_json(args.cfg)
    phone2id = read_table(args.phone_table)
    cfg.num_phones = max(cfg.num_phones, max(phone2id.values()) + 1)
    if args.speaker_table:
        sp = read_table(args.speaker_table)
        cfg.num_speakers = max(cfg.num_speakers, max(sp.values()) + 1)
    model = load_model(args.model_dir, cfg).to(device)

    text_buckets = [int(x) for x in args.text_buckets.split(",")]
    frame_buckets = [int(x) for x in args.frame_buckets.split(",")]
    scales = (args.noise_scale, args.length_scale, args.noise_scale_w)
    graphs = export_graphs(cfg, model, text_buckets, frame_buckets, scales)
    write_graphs(graphs, args.out_dir, {
        "sample_rate": cfg.data.sampling_rate,
        "hop_length": model.hop,
        "text_buckets": text_buckets,
        "frame_buckets": frame_buckets,
        "frames_per_text": FRAMES_PER_TEXT,
        "scales": list(scales),
        "device": str(device),
    })
    print(f"exported torch.export graphs to {args.out_dir}")


if __name__ == "__main__":
    main()
