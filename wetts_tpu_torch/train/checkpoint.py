"""Checkpointing with `torch.save` (port of wetts_tpu/train/checkpoint.py).

One file per saved step, `ckpt_<step>.pt` in the model directory, holding
the networks' state_dicts (G, D, and the duration and WavLM discriminators
where the state has them), their optimiser states, each optimiser's
parameter names and the step; the same resume-latest semantics (numeric
step discovery) as the JAX package's single-directory checkpoints, and the
newest `max_to_keep` files are kept. A file is written under a temporary
name and renamed, so a killed save never leaves a truncated checkpoint
behind.

Restores are tolerant, as the JAX package's (`strict=False`, the
reference's partial load, task.py:43-49): a network or optimiser that the
checkpoint lacks keeps its fresh values, and so do the tensors that a
network's entry lacks and their optimiser moments; a tensor whose shape
differs raises. So a run that turns on `use_wd` or a duration
discriminator resumes from a checkpoint made without it.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

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


def _param_names(net: torch.nn.Module) -> List[str]:
    return [name for name, _ in net.named_parameters()]


def save_checkpoint(model_dir: str, state: GANTrainState, step: int,
                    max_to_keep: int = 5) -> None:
    os.makedirs(model_dir, exist_ok=True)
    payload = {"step": step, "param_names": {}}
    for name, net, opt in state.nets():
        payload[name] = net.state_dict()
        payload[name.replace("net", "opt", 1)] = opt.state_dict()
        payload["param_names"][name] = _param_names(net)
    tmp = _path(model_dir, step) + f".{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, _path(model_dir, step))
    for old in saved_steps(model_dir)[:-max_to_keep]:
        os.remove(_path(model_dir, old))


def _restore_optimizer(opt: torch.optim.Optimizer, saved: Dict,
                       names: List[str], saved_names: Optional[List[str]]
                       ) -> None:
    """Load `saved` into `opt`, matching parameters by name where the saved
    names differ from the current ones: a parameter without saved moments
    keeps its fresh (empty) state. The optimiser has one parameter group
    (`make_optimizer`); its hyperparameters come from `saved`."""
    if saved_names is None or saved_names == names:
        opt.load_state_dict(saved)
        return
    index = {n: i for i, n in enumerate(saved_names)}
    moments = {i: saved["state"][index[n]] for i, n in enumerate(names)
               if n in index and index[n] in saved["state"]}
    (group,) = saved["param_groups"]
    opt.load_state_dict({"state": moments, "param_groups": [
        dict(group, params=list(range(len(names))))]})


def load_checkpoint(model_dir: str, state: GANTrainState,
                    step: Optional[int] = None) -> GANTrainState:
    """Restore `state` in place from `step` (default: the latest); without a
    checkpoint the state is returned as it is. Tolerant (module
    docstring): what the checkpoint lacks keeps its current values."""
    if step is None:
        step = latest_step(model_dir)
    if step is None:
        return state
    device = next(state.net_g.parameters()).device
    payload = torch.load(_path(model_dir, step), map_location=device,
                         weights_only=True)
    saved_names = payload.get("param_names", {})
    for name, net, opt in state.nets():
        if name not in payload:
            continue
        # strict=False keeps missing tensors and still raises on a shape
        net.load_state_dict(payload[name], strict=False)
        opt_name = name.replace("net", "opt", 1)
        if opt_name in payload:
            _restore_optimizer(opt, payload[opt_name], _param_names(net),
                               saved_names.get(name))
    state.step = int(payload["step"])
    return state
