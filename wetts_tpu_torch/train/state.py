"""Train state: the generator, the discriminator, VITS2's duration
discriminator where the config has one, their optimisers and the step count
(port of wetts_tpu/train/state.py).

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
    """G, D and the duration discriminator (each a module with its
    optimiser; the last two None without `use_duration_discriminator`) and
    the number of steps taken."""

    net_g: nn.Module
    opt_g: torch.optim.Optimizer
    net_d: nn.Module
    opt_d: torch.optim.Optimizer
    step: int = 0
    net_dur_d: Optional[nn.Module] = None
    opt_dur_d: Optional[torch.optim.Optimizer] = None

    @classmethod
    def create(cls, cfg: Config, net_g: nn.Module, net_d: nn.Module,
               net_dur_d: Optional[nn.Module] = None) -> "GANTrainState":
        return cls(net_g, make_optimizer(cfg, net_g),
                   net_d, make_optimizer(cfg, net_d), net_dur_d=net_dur_d,
                   opt_dur_d=(None if net_dur_d is None
                              else make_optimizer(cfg, net_dur_d)))

    def set_learning_rate(self, lr: float) -> None:
        for opt in (self.opt_g, self.opt_d, self.opt_dur_d):
            if opt is None:
                continue
            for group in opt.param_groups:
                group["lr"] = lr


def epoch_lr(cfg: Config, epoch: int) -> float:
    """lr for `epoch` (1-based), matching torch ExponentialLR semantics."""
    return cfg.train.learning_rate * (cfg.train.lr_decay ** (epoch - 1))
