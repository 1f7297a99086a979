"""Train state: the generator, the discriminator, VITS2's duration
discriminator and the WavLM (SLM) discriminator where the run has them,
their optimisers and the step count (port of wetts_tpu/train/state.py).

The reference trains each network with its own AdamW (lr 2e-4, betas
(0.8, 0.99), eps 1e-9, torch's default weight decay 0.01) and decays the
learning rate per epoch (ExponentialLR, gamma 0.999875; reference
wetts/vits/train.py:228-299). The host loop sets `lr0 * gamma ** (epoch - 1)`
on the param groups at the start of each epoch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from wetts_tpu_torch.config import Config


def make_optimizer(cfg: Config, module: nn.Module) -> torch.optim.AdamW:
    t = cfg.train
    return torch.optim.AdamW(module.parameters(), lr=t.learning_rate,
                             betas=tuple(t.betas), eps=t.eps,
                             weight_decay=0.01)


@dataclass
class GANTrainState:
    """G, D, the duration discriminator and the WavLM discriminator (each a
    module with its optimiser; a module and its optimiser are None where
    the run has no such network) and the number of steps taken. The
    parameters and the optimiser state are f32 whatever the compute type
    (bf16 runs under autocast)."""

    net_g: nn.Module
    opt_g: torch.optim.Optimizer
    net_d: nn.Module
    opt_d: torch.optim.Optimizer
    step: int = 0
    net_dur_d: Optional[nn.Module] = None
    opt_dur_d: Optional[torch.optim.Optimizer] = None
    net_wd: Optional[nn.Module] = None
    opt_wd: Optional[torch.optim.Optimizer] = None

    # (net, optimiser) attribute pairs, in the order of `nets()`
    NAMES = (("net_g", "opt_g"), ("net_d", "opt_d"),
             ("net_dur_d", "opt_dur_d"), ("net_wd", "opt_wd"))

    @classmethod
    def create(cls, cfg: Config, net_g: nn.Module, net_d: nn.Module,
               net_dur_d: Optional[nn.Module] = None,
               net_wd: Optional[nn.Module] = None) -> "GANTrainState":
        def opt(net):
            return None if net is None else make_optimizer(cfg, net)

        return cls(net_g, opt(net_g), net_d, opt(net_d),
                   net_dur_d=net_dur_d, opt_dur_d=opt(net_dur_d),
                   net_wd=net_wd, opt_wd=opt(net_wd))

    def nets(self):
        """(name, net, optimiser) of every network the state holds."""
        for net, opt in self.NAMES:
            if getattr(self, net) is not None:
                yield net, getattr(self, net), getattr(self, opt)

    def set_learning_rate(self, lr: float) -> None:
        for _, _, opt in self.nets():
            for group in opt.param_groups:
                group["lr"] = lr


def epoch_lr(cfg: Config, epoch: int) -> float:
    """lr for `epoch` (1-based), matching torch ExponentialLR semantics."""
    return cfg.train.learning_rate * (cfg.train.lr_decay ** (epoch - 1))
