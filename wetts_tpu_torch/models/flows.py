"""The VITS1 prior flow (port of wetts_tpu/models/flows.py, VITS1 only;
reference wetts/vits/model/flows.py:457-516 and modules.py:98-106):
mean-only affine couplings over channel halves interleaved with flips.
Both directions are differentiable and masked as the JAX package masks
them. A mean-only coupling has log-det 0 and the KL loss uses none, so
neither direction returns one. The VITS2 transformer flows are a later
slice."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from wetts_tpu_torch.models.layers import Conv1d
from wetts_tpu_torch.models.wavenet import WN


class Flip(nn.Module):
    """Parameterless flip of the channel axis."""

    def forward(self, x, x_mask, g=None, reverse=False, generator=None):
        return torch.flip(x, dims=[1])


class ResidualCouplingLayer(nn.Module):
    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 mean_only: bool = True):
        super().__init__()
        assert channels % 2 == 0
        self.half_channels = channels // 2
        self.mean_only = mean_only
        self.pre = Conv1d(self.half_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.post = Conv1d(hidden_channels,
                           self.half_channels * (2 - mean_only), 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, reverse: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, C, T]. Returns the coupled x (the log-det of a mean-only
        coupling is 0 and is not returned)."""
        x0, x1 = torch.split(x, self.half_channels, dim=1)
        h = self.enc(self.pre(x0) * x_mask, x_mask, g=g,
                     generator=generator)
        stats = self.post(h) * x_mask
        if self.mean_only:
            m, logs = stats, torch.zeros_like(stats)
        else:
            m, logs = torch.split(stats, self.half_channels, dim=1)
        if not reverse:
            x1 = m + x1 * torch.exp(logs) * x_mask
        else:
            x1 = (x1 - m) * torch.exp(-logs) * x_mask
        return torch.cat([x0, x1], dim=1)


class ResidualCouplingBlock(nn.Module):
    """n_flows x (mean-only coupling + flip), the VITS1 flow stack."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate,
                n_layers, gin_channels=gin_channels, mean_only=True))
            self.flows.append(Flip())

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, reverse: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        flows = reversed(self.flows) if reverse else self.flows
        for flow in flows:
            x = flow(x, x_mask, g=g, reverse=reverse, generator=generator)
        return x
