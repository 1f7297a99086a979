"""Duration predictors, inference side (port of wetts_tpu/models/duration.py;
reference wetts/vits/model/duration_predictors.py).

- DDSConv dilated depth-separable stack (:12-57),
- ConvFlow neural-spline coupling (:60-122) with the /sqrt(filter_channels)
  parameter scaling (:100-104),
- ElementwiseAffine (:125-141) and the flip,
- StochasticDurationPredictor, reverse sampling only: the reversed flow chain
  drops its first ConvFlow (:254-263). The module holds every parameter of
  the reference (its posterior flows too) so state_dicts map one to one;
  the training NLL is a later slice.
- DurationPredictor conv-relu-LN x2 (:266-311).

The noise comes from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from wetts_tpu_torch.models.flows import Flip
from wetts_tpu_torch.models.layers import Conv1d, LayerNorm
from wetts_tpu_torch.ops.splines import piecewise_rational_quadratic_transform


class DDSConv(nn.Module):
    """Dilated depth-separable conv stack with LN + exact gelu."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int):
        super().__init__()
        self.convs_sep = nn.ModuleList()
        self.convs_1x1 = nn.ModuleList()
        self.norms_1 = nn.ModuleList()
        self.norms_2 = nn.ModuleList()
        for i in range(n_layers):
            d = kernel_size ** i
            self.convs_sep.append(Conv1d(
                channels, channels, kernel_size,
                padding=(kernel_size * d - d) // 2, dilation=d,
                groups=channels))
            self.convs_1x1.append(Conv1d(channels, channels, 1))
            self.norms_1.append(LayerNorm(channels))
            self.norms_2.append(LayerNorm(channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        if g is not None:
            x = x + g
        for sep, pw, n1, n2 in zip(self.convs_sep, self.convs_1x1,
                                   self.norms_1, self.norms_2):
            y = F.gelu(n1(sep(x * x_mask)))
            y = F.gelu(n2(pw(y)))
            x = x + y
        return x * x_mask


class ConvFlow(nn.Module):
    """Rational-quadratic spline coupling over 2-channel duration latents."""

    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, n_layers: int, num_bins: int = 10,
                 tail_bound: float = 5.0):
        super().__init__()
        self.half_channels = in_channels // 2
        self.filter_channels = filter_channels
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.pre = Conv1d(self.half_channels, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = Conv1d(filter_channels,
                           self.half_channels * (num_bins * 3 - 1), 1)

    def forward(self, x, x_mask, g=None, reverse=False):
        x0, x1 = torch.split(x, self.half_channels, dim=1)
        h = self.convs(self.pre(x0), x_mask, g=g)
        h = self.proj(h) * x_mask
        b, _, t = x0.shape
        # channel-major split, as the reference's reshape(b, c, -1, t)
        h = h.reshape(b, self.half_channels, -1, t).permute(0, 1, 3, 2)
        denom = math.sqrt(self.filter_channels)
        k = self.num_bins
        x1, _ = piecewise_rational_quadratic_transform(
            x1, h[..., :k] / denom, h[..., k: 2 * k] / denom, h[..., 2 * k:],
            inverse=reverse, tails="linear", tail_bound=self.tail_bound)
        return torch.cat([x0, x1], dim=1) * x_mask


class ElementwiseAffine(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x, x_mask, g=None, reverse=False):
        if not reverse:
            return (self.m + torch.exp(self.logs) * x) * x_mask
        return (x - self.m) * torch.exp(-self.logs) * x_mask


class StochasticDurationPredictor(nn.Module):
    def __init__(self, in_channels: int, kernel_size: int, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        fc = in_channels  # reference quirk: filter_channels = in_channels
        self.flows = nn.ModuleList([ElementwiseAffine(2)])
        self.post_flows = nn.ModuleList([ElementwiseAffine(2)])
        for _ in range(n_flows):
            self.flows.extend([ConvFlow(2, fc, kernel_size, n_layers=3),
                               Flip()])
        for _ in range(4):
            self.post_flows.extend([ConvFlow(2, fc, kernel_size, n_layers=3),
                                    Flip()])
        self.post_pre = Conv1d(1, fc, 1)
        self.post_proj = Conv1d(fc, fc, 1)
        self.post_convs = DDSConv(fc, kernel_size, n_layers=3)
        self.pre = Conv1d(in_channels, fc, 1)
        self.proj = Conv1d(fc, fc, 1)
        self.convs = DDSConv(fc, kernel_size, n_layers=3)
        if gin_channels != 0:
            self.cond = Conv1d(gin_channels, fc, 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, noise_scale: float = 1.0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Reverse sampling: hidden x [B, C, T] -> log-durations [B, 1, T]."""
        x = self.pre(x)
        if g is not None and hasattr(self, "cond"):
            x = x + self.cond(g)
        x = self.proj(self.convs(x, x_mask)) * x_mask
        flows = list(reversed(self.flows))
        flows = flows[:-2] + [flows[-1]]  # drop the "useless" ConvFlow
        z = torch.randn(x.shape[0], 2, x.shape[2], generator=generator,
                        device=x.device, dtype=x.dtype) * noise_scale
        for flow in flows:
            z = flow(z, x_mask, g=x, reverse=True)
        return z[:, :1]


class DurationPredictor(nn.Module):
    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, gin_channels: int = 0):
        super().__init__()
        pad = kernel_size // 2
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size,
                             padding=pad)
        self.norm_1 = LayerNorm(filter_channels)
        self.conv_2 = Conv1d(filter_channels, filter_channels, kernel_size,
                             padding=pad)
        self.norm_2 = LayerNorm(filter_channels)
        self.proj = Conv1d(filter_channels, 1, 1)
        if gin_channels != 0:
            self.cond = Conv1d(gin_channels, in_channels, 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        if g is not None and hasattr(self, "cond"):
            x = x + self.cond(g)
        x = self.norm_1(torch.relu(self.conv_1(x * x_mask)))
        x = self.norm_2(torch.relu(self.conv_2(x * x_mask)))
        return self.proj(x * x_mask) * x_mask
