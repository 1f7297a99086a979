"""Duration predictors (port of wetts_tpu/models/duration.py; reference
wetts/vits/model/duration_predictors.py).

- DDSConv dilated depth-separable stack (:12-57),
- ConvFlow neural-spline coupling (:60-122) with the /sqrt(filter_channels)
  parameter scaling (:100-104),
- ElementwiseAffine (:125-141), the Log flow (:144-153) and the flip,
- StochasticDurationPredictor (:156-263): `forward` samples log-durations
  through the reversed flow chain without its first ConvFlow (:254-263);
  `nll` is the training direction, the posterior flow over (u, nu), the
  input detach (:213) and the per-utterance `nll + logq` (:221-253).
- DurationPredictor conv-relu-LN x2 (:266-311).

A flow called with `reverse=False` returns (y, logdet [B]); with
`reverse=True` it returns y. Noise and dropout masks come from an explicit
`torch.Generator` through ops/random.py.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from wetts_tpu_torch.models.layers import Conv1d, LayerNorm
from wetts_tpu_torch.ops import random
from wetts_tpu_torch.ops.splines import piecewise_rational_quadratic_transform


class DDSConv(nn.Module):
    """Dilated depth-separable conv stack with LN + exact gelu; dropout on
    each layer's residual branch."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
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
                g: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if g is not None:
            x = x + g
        for sep, pw, n1, n2 in zip(self.convs_sep, self.convs_1x1,
                                   self.norms_1, self.norms_2):
            y = F.gelu(n1(sep(x * x_mask)))
            y = F.gelu(n2(pw(y)))
            x = x + random.dropout(y, self.p_dropout, self.training,
                                   generator)
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
        x1, logabsdet = piecewise_rational_quadratic_transform(
            x1, h[..., :k] / denom, h[..., k: 2 * k] / denom, h[..., 2 * k:],
            inverse=reverse, tails="linear", tail_bound=self.tail_bound)
        x = torch.cat([x0, x1], dim=1) * x_mask
        if reverse:
            return x
        return x, torch.sum(logabsdet * x_mask, dim=(1, 2))


class ElementwiseAffine(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x, x_mask, g=None, reverse=False):
        if not reverse:
            y = (self.m + torch.exp(self.logs) * x) * x_mask
            return y, torch.sum(self.logs * x_mask, dim=(1, 2))
        return (x - self.m) * torch.exp(-self.logs) * x_mask


class Flip(nn.Module):
    """Parameterless flip of the channel axis (log-det 0)."""

    def forward(self, x, x_mask, g=None, reverse=False):
        x = torch.flip(x, dims=[1])
        if reverse:
            return x
        return x, x.new_zeros(x.shape[0])


def log_flow_forward(x: torch.Tensor, x_mask: torch.Tensor):
    """The Log flow, forward: y = log(max(x, 1e-5)) * mask, logdet -sum(y)."""
    y = torch.log(torch.clamp_min(x, 1e-5)) * x_mask
    return y, torch.sum(-y, dim=(1, 2))


class StochasticDurationPredictor(nn.Module):
    def __init__(self, in_channels: int, kernel_size: int, n_flows: int = 4,
                 gin_channels: int = 0, p_dropout: float = 0.5):
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
        self.post_convs = DDSConv(fc, kernel_size, n_layers=3,
                                  p_dropout=p_dropout)
        self.pre = Conv1d(in_channels, fc, 1)
        self.proj = Conv1d(fc, fc, 1)
        self.convs = DDSConv(fc, kernel_size, n_layers=3,
                             p_dropout=p_dropout)
        if gin_channels != 0:
            self.cond = Conv1d(gin_channels, fc, 1)

    def _condition(self, x, x_mask, g, generator):
        """The text-side conditioning; x and g are detached (:213)."""
        x = self.pre(x.detach())
        if g is not None and hasattr(self, "cond"):
            x = x + self.cond(g.detach())
        return self.proj(self.convs(x, x_mask, generator=generator)) * x_mask

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, noise_scale: float = 1.0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Reverse sampling: hidden x [B, C, T] -> log-durations [B, 1, T]."""
        x = self._condition(x, x_mask, g, generator)
        flows = list(reversed(self.flows))
        flows = flows[:-2] + [flows[-1]]  # drop the "useless" ConvFlow
        z = random.normal((x.shape[0], 2, x.shape[2]), x.device, x.dtype,
                          generator) * noise_scale
        for flow in flows:
            z = flow(z, x_mask, g=x, reverse=True)
        return z[:, :1]

    def nll(self, x: torch.Tensor, x_mask: torch.Tensor, w: torch.Tensor,
            g: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Training direction: hidden x [B, C, T], durations w [B, 1, T] ->
        per-utterance negative log-likelihood `nll + logq` [B]."""
        x = self._condition(x, x_mask, g, generator)
        h_w = self.post_pre(w)
        h_w = self.post_convs(h_w, x_mask, generator=generator)
        h_w = self.post_proj(h_w) * x_mask
        e_q = random.normal((w.shape[0], 2, w.shape[2]), w.device, w.dtype,
                            generator) * x_mask
        z_q = e_q
        logdet_tot_q = 0.0
        for flow in self.post_flows:
            z_q, logdet_q = flow(z_q, x_mask, g=x + h_w)
            logdet_tot_q = logdet_tot_q + logdet_q
        z_u, z1 = z_q[:, 0:1], z_q[:, 1:2]
        u = torch.sigmoid(z_u) * x_mask
        z0 = (w - u) * x_mask
        logdet_tot_q = logdet_tot_q + torch.sum(
            (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, dim=(1, 2))
        log2pi = math.log(2 * math.pi)
        logq = torch.sum(-0.5 * (log2pi + e_q ** 2) * x_mask,
                         dim=(1, 2)) - logdet_tot_q

        z0, logdet_tot = log_flow_forward(z0, x_mask)
        z = torch.cat([z0, z1], dim=1)
        for flow in self.flows:
            z, logdet = flow(z, x_mask, g=x)
            logdet_tot = logdet_tot + logdet
        nll = torch.sum(0.5 * (log2pi + z ** 2) * x_mask,
                        dim=(1, 2)) - logdet_tot
        return nll + logq


class DurationPredictor(nn.Module):
    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, gin_channels: int = 0,
                 p_dropout: float = 0.5):
        super().__init__()
        self.p_dropout = p_dropout
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
                g: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.detach()
        if g is not None and hasattr(self, "cond"):
            x = x + self.cond(g.detach())
        x = self.norm_1(torch.relu(self.conv_1(x * x_mask)))
        x = random.dropout(x, self.p_dropout, self.training, generator)
        x = self.norm_2(torch.relu(self.conv_2(x * x_mask)))
        x = random.dropout(x, self.p_dropout, self.training, generator)
        return self.proj(x * x_mask) * x_mask
