"""The system under test and the reference, built from one configuration file
and one seed.

The benchmark makes the weights itself, on the device, from the seed: one
uniform draw of every parameter the reference's inference path reads, cut
into tensors, at the scale of torch's default init (U(-1/sqrt(fan_in), +),
fan_in = numel / shape[0]), LayerNorm gains 1 and biases 0, weight-norm g =
||v||. The same state dict is loaded into the program's `Synthesizer` and
into the reference's; the program's parameters that inference never reads
(the posterior encoder, the duration predictor's posterior flows) stay at
the program's own zero init.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import ROOT

PHONES_LIST = os.path.join("wetts_tpu_torch", "assets", "lexicon",
                           "phones.list")
ARPABET = [f"{v}{s}" for v in ("AA AE AH AO AW AY EH ER EY IH IY OW OY UH "
                               "UW").split() for s in range(3)] + (
    "B CH D DH F G HH JH K L M N NG P R S SH T TH V W Y Z ZH").split()


# torch LayerNorm modules of the frontend's BERT, whose weight is a gain
NORM_MODULES = ("LayerNorm", "norm1", "norm2")
# rows of the length-scale probe encoded at a time
PROBE_ROWS = 32
# draws of the weights at most, where a configuration bounds the probe
# rows' spread (build_system)
WEIGHT_DRAWS = 8


def load_config(name: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json"),
              encoding="utf8") as f:
        return json.load(f)


def phone_table() -> Dict[str, int]:
    """`sil`, the vendored phones.list, #0-#4 and the ARPAbet phones."""
    with open(os.path.join(ROOT, PHONES_LIST), encoding="utf8") as f:
        phones = (["sil"] + f.read().split() + [f"#{i}" for i in range(5)]
                  + ARPABET)
    return {p: i for i, p in enumerate(phones)}


def speaker_table(cfg: dict) -> Dict[str, int]:
    return {f"spk{i}": i for i in range(cfg["num_speakers"])}


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    return (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % 2 ** 63


@torch.no_grad()
def make_weights(shapes: Dict[str, torch.Size], seed: int, device,
                 stream: int = 0) -> Dict[str, torch.Tensor]:
    """Every tensor of `shapes` from one uniform draw on `device`."""
    names = sorted(shapes)
    total = sum(shapes[n].numel() for n in names)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))
    flat = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for name in names:
        shape = shapes[name]
        n = shape.numel()
        parts = name.split(".")
        leaf, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
        norm = parent in NORM_MODULES
        if leaf == "gamma" or (norm and leaf == "weight"):
            out[name] = torch.ones(shape, device=device)
        elif leaf == "beta" or (norm and leaf == "bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            fan_in = n // shape[0] if len(shape) > 1 else n
            bound = fan_in ** -0.5
            out[name] = (flat[off: off + n].view(shape) * 2 - 1) * bound
        off += n
    for name in names:
        if name.endswith(".weight_g"):
            v = out[name[: -len("g")] + "v"]
            out[name] = torch.sqrt(
                (v * v).sum(dim=tuple(range(1, v.ndim)), keepdim=True))
    return out


def build_reference(cfg: dict, device, weights=None):
    """The reference synthesizer on `device`, with `weights` if given."""
    from benchmark.reference.vits import Synthesizer

    with torch.device(device):
        model = Synthesizer(cfg).eval()
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    return model


def build_system(cfg: dict, seed: int, device, frontend=None, probe=None):
    """(weights, the engine, the calibrated length_scale): the weights drawn
    for every parameter the reference reads, the length scale calibrated on
    the reference over `probe`, the engine built with both.

    Where the configuration's `assumed` sets `probe_row_spread`, a draw
    whose probe rows' frames per phone lie farther than that share from
    their mean is drawn again, from the seed's next weight stream, up to
    WEIGHT_DRAWS times (the narrowest draw kept): the stochastic duration
    predictor of some draws gives a few phones tens of frames, and the
    padded decode of such a seed costs more per realized second than any
    other seed's."""
    ref = build_reference(cfg, device)
    shapes = {k: v.shape for k, v in ref.state_dict().items()}
    spread = cfg["assumed"].get("probe_row_spread")
    best = None
    for draw in range(WEIGHT_DRAWS):
        weights = make_weights(shapes, seed, device,
                               stream=0 if draw == 0 else 100 + draw)
        ref.load_state_dict(weights, strict=True)
        length_scale, rows = calibrate_length_scale(cfg, ref, seed, device,
                                                    probe)
        mean = sum(rows) / len(rows)
        width = max(max(rows) / mean - 1, 1 - min(rows) / mean)
        if best is None or width < best[0]:
            best = (width, weights, length_scale)
        if spread is None or width <= spread:
            break
    _, weights, length_scale = best
    del ref
    engine = build_engine(cfg, weights, seed, device, length_scale,
                          frontend=frontend)
    return weights, engine, length_scale


def build_program_model(cfg: dict, weights: Dict[str, torch.Tensor], device):
    """The port's Synthesizer on `device` with the benchmark's weights."""
    from wetts_tpu_torch.config import Config
    from wetts_tpu_torch.models.synthesizer import Synthesizer

    with torch.device(device):
        model = Synthesizer(Config.from_dict(cfg))
    result = model.load_state_dict(weights, strict=False)
    if result.unexpected_keys:
        raise RuntimeError(f"the program has no parameters "
                           f"{result.unexpected_keys[:5]}")
    return model.eval()


@torch.no_grad()
def calibrate_length_scale(cfg: dict, reference, seed: int, device,
                           probe=None) -> Tuple[float, List[float]]:
    """The length_scale at which the seed's weights give the configuration's
    `frames_per_phone` on average, within 1%, over a probe: the cell's own
    requests (id lists and speakers) where its traffic driver gives them,
    else `probe_requests` raw-phone requests of `probe_phones` ids drawn
    uniformly, over the speakers in turn. The duration noise comes from a
    fixed generator. The work per phone is then the same for every seed.
    Durations are ceil(w * length_scale), so rescaling by target / measured
    converges in a few steps. Returns the scale and the frames per phone
    of each probe row at the scale last measured."""
    a = cfg["assumed"]
    if probe is None:
        rng = np.random.default_rng(sub_seed(seed, 5))
        probe = [([0] + [int(i) for i in rng.integers(
            1, cfg["num_phones"], a["probe_phones"] - 1)],
                  k % cfg["num_speakers"])
                 for k in range(a["probe_requests"])]
    phones = sum(len(ids) for ids, _ in probe)
    scale = a["length_scale"]
    for _ in range(8):
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 6))
        frames, rows_fpp = 0, []
        for lo in range(0, len(probe), PROBE_ROWS):
            rows = probe[lo: lo + PROBE_ROWS]
            t = max(len(ids) for ids, _ in rows)
            x = torch.zeros((len(rows), t), dtype=torch.long)
            for r, (ids, _) in enumerate(rows):
                x[r, : len(ids)] = torch.tensor(ids)
            g = reference.speaker(torch.tensor([s for _, s in rows],
                                               device=device))
            lengths = torch.tensor([len(ids) for ids, _ in rows],
                                   device=device)
            _, y_len, _ = reference.encode_prior(
                x.to(device), lengths, g, a["noise_scale"], scale,
                a["noise_scale_w"], t * 12, gen)
            frames += int(y_len.sum())
            rows_fpp += (y_len.double() / lengths).tolist()
        per_phone = frames / phones
        if abs(per_phone / a["frames_per_phone"] - 1) < 0.01:
            break
        scale *= a["frames_per_phone"] / per_phone
    return scale, rows_fpp


def build_engine(cfg: dict, weights, seed: int, device, length_scale: float,
                 frontend=None):
    """The port's SynthesisEngine at the configuration's scales, its noise
    generator seeded from the run's seed."""
    from wetts_tpu_torch.config import Config
    from wetts_tpu_torch.serving.engine import SynthesisEngine

    a = cfg["assumed"]
    model = build_program_model(cfg, weights, device)
    return SynthesisEngine(
        Config.from_dict(cfg), model, phone_table(), speaker_table(cfg),
        frontend=frontend, noise_scale=a["noise_scale"],
        length_scale=length_scale, noise_scale_w=a["noise_scale_w"],
        seed=sub_seed(seed, 1), device=device)
