"""WaveNet residual stack WN (port of wetts_tpu/models/wavenet.py; reference
wetts/vits/model/modules.py:10-95): dilated weight-normed convs with the
gated tanh/sigmoid activation, speaker conditioning projected once to
2*H*n_layers channels, and the residual/skip split. The dropout site on the
gated activations is kept (`p_dropout`, 0 in every VITS use)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from wetts_tpu_torch.models.layers import (
    Conv1d,
    fused_add_tanh_sigmoid_multiply,
    get_padding,
)
from wetts_tpu_torch.ops import random


class WN(nn.Module):
    def __init__(self, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        assert kernel_size % 2 == 1
        self.hidden_channels = hidden_channels
        self.n_layers = n_layers
        if gin_channels > 0:
            self.cond_layer = Conv1d(gin_channels,
                                     2 * hidden_channels * n_layers, 1,
                                     weight_norm=True)
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            d = dilation_rate ** i
            self.in_layers.append(Conv1d(
                hidden_channels, 2 * hidden_channels, kernel_size,
                padding=get_padding(kernel_size, d), dilation=d,
                weight_norm=True))
            out = 2 * hidden_channels if i < n_layers - 1 else hidden_channels
            self.res_skip_layers.append(Conv1d(hidden_channels, out, 1,
                                               weight_norm=True))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, H, T]; x_mask [B, 1, T]; g [B, gin, 1] or None."""
        h = self.hidden_channels
        output = torch.zeros_like(x)
        g_all = self.cond_layer(g) if (
            g is not None and hasattr(self, "cond_layer")) else None
        for i, (in_layer, res_skip) in enumerate(
                zip(self.in_layers, self.res_skip_layers)):
            x_in = in_layer(x)
            g_l = (g_all[:, i * 2 * h: (i + 1) * 2 * h] if g_all is not None
                   else torch.zeros_like(x_in))
            acts = random.dropout(
                fused_add_tanh_sigmoid_multiply(x_in, g_l, h),
                self.p_dropout, self.training, generator)
            rs = res_skip(acts)
            if i < self.n_layers - 1:
                x = (x + rs[:, :h]) * x_mask
                output = output + rs[:, h:]
            else:
                output = output + rs
        return output * x_mask
