"""GAN discriminators of VITS-base (port of wetts_tpu/models/discriminators.py;
reference wetts/vits/model/discriminators.py):

- DiscriminatorP (:21-95): reflect-pad the waveform to a multiple of the
  period, fold it to 2D, a stack of (k, 1)-kernel strided convs,
- DiscriminatorS (:98-124): a grouped 1D conv stack,
- MultiPeriodDiscriminator (:228-254) = S + P(2, 3, 5, 7, 11).

Waveforms are [B, T, 1], as in the JAX package; every sub-discriminator
returns (flattened logits [B, N], feature maps). Feature maps come back
channel-last ([B, T', C] and [B, H, W, C]) so they compare one to one with
the JAX package's. Parameters keep the reference's state_dict names
(`discriminators.{i}.convs.{j}.weight_g/weight_v/bias`, `conv_post`). The
multi-resolution, duration and WavLM discriminators are later slices.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wetts_tpu_torch.models.layers import (
    LRELU_SLOPE,
    Conv1d,
    Conv2d,
    get_padding,
)


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = get_padding(kernel_size, 1)
        channels = [1, 32, 128, 512, 1024]
        self.convs = nn.ModuleList([
            Conv2d(c_in, c_out, kernel_size, stride, pad, weight_norm=True)
            for c_in, c_out in zip(channels[:-1], channels[1:])])
        self.convs.append(Conv2d(1024, 1024, kernel_size, 1, pad,
                                 weight_norm=True))
        self.conv_post = Conv2d(1024, 1, 3, 1, 1, weight_norm=True)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x [B, T, 1] -> (logits [B, N], feature maps [B, H, W, C])."""
        b, t, _ = x.shape
        x = x.transpose(1, 2)  # [B, 1, T]
        if t % self.period != 0:
            n_pad = self.period - (t % self.period)
            x = F.pad(x, (0, n_pad), mode="reflect")
            t = t + n_pad
        x = x.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x.permute(0, 2, 3, 1))
        x = self.conv_post(x)
        fmap.append(x.permute(0, 2, 3, 1))
        return fmap[-1].reshape(b, -1), fmap


class DiscriminatorS(nn.Module):
    # (out channels, kernel, stride, groups, padding) per conv
    SPECS = ((16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20),
             (1024, 41, 4, 64, 20), (1024, 41, 4, 256, 20),
             (1024, 5, 1, 1, 2))

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList()
        c_in = 1
        for ch, k, s, g, p in self.SPECS:
            self.convs.append(Conv1d(c_in, ch, k, padding=p, groups=g,
                                     stride=s, weight_norm=True))
            c_in = ch
        self.conv_post = Conv1d(c_in, 1, 3, padding=1, weight_norm=True)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x [B, T, 1] -> (logits [B, N], feature maps [B, T', C])."""
        b = x.shape[0]
        x = x.transpose(1, 2)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x.transpose(1, 2))
        x = self.conv_post(x)
        fmap.append(x.transpose(1, 2))
        return fmap[-1].reshape(b, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [DiscriminatorS()] + [DiscriminatorP(p) for p in periods])

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """Real and generated waveforms [B, T, 1] -> (real logits, generated
        logits, real feature maps, generated feature maps), one entry per
        sub-discriminator."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            r, fr = d(y)
            g, fg = d(y_hat)
            y_d_rs.append(r)
            y_d_gs.append(g)
            fmap_rs.append(fr)
            fmap_gs.append(fg)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
