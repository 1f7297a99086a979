"""Checkpointing with `torch.save` (port of wetts_tpu/train/checkpoint.py).

One file per saved step, `ckpt_<step>.pt` in the model directory, holding
the networks' state_dicts (G, D, and the duration discriminator where the
state has one), their optimiser states and the step; the same
resume-latest semantics (numeric step discovery) as the JAX package's
single-directory checkpoints, and the newest `max_to_keep` files are kept.
A file is written under a temporary name and renamed, so a killed save never
leaves a truncated checkpoint behind.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from wetts_tpu_torch.train.state import GANTrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _path(model_dir: str, step: int) -> str:
    return os.path.join(model_dir, f"ckpt_{step}.pt")


def saved_steps(model_dir: str) -> List[int]:
    """Steps that have a checkpoint in `model_dir`, ascending."""
    if not os.path.isdir(model_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(model_dir)) if m)


def latest_step(model_dir: str) -> Optional[int]:
    steps = saved_steps(model_dir)
    return steps[-1] if steps else None


def save_checkpoint(model_dir: str, state: GANTrainState, step: int,
                    max_to_keep: int = 5) -> None:
    os.makedirs(model_dir, exist_ok=True)
    payload = {
        "step": step,
        "net_g": state.net_g.state_dict(),
        "net_d": state.net_d.state_dict(),
        "opt_g": state.opt_g.state_dict(),
        "opt_d": state.opt_d.state_dict(),
    }
    if state.net_dur_d is not None:
        payload["net_dur_d"] = state.net_dur_d.state_dict()
        payload["opt_dur_d"] = state.opt_dur_d.state_dict()
    tmp = _path(model_dir, step) + f".{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, _path(model_dir, step))
    for old in saved_steps(model_dir)[:-max_to_keep]:
        os.remove(_path(model_dir, old))


def load_checkpoint(model_dir: str, state: GANTrainState,
                    step: Optional[int] = None) -> GANTrainState:
    """Restore `state` in place from `step` (default: the latest); without a
    checkpoint the state is returned as it is. A state with a duration
    discriminator needs a checkpoint that holds one (KeyError)."""
    if step is None:
        step = latest_step(model_dir)
    if step is None:
        return state
    device = next(state.net_g.parameters()).device
    payload = torch.load(_path(model_dir, step), map_location=device,
                         weights_only=True)
    state.net_g.load_state_dict(payload["net_g"])
    state.net_d.load_state_dict(payload["net_d"])
    state.opt_g.load_state_dict(payload["opt_g"])
    state.opt_d.load_state_dict(payload["opt_d"])
    if state.net_dur_d is not None:
        state.net_dur_d.load_state_dict(payload["net_dur_d"])
        state.opt_dur_d.load_state_dict(payload["opt_dur_d"])
    state.step = int(payload["step"])
    return state
