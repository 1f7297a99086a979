"""Convolutions, LayerNorm and relative-position attention in plain PyTorch,
for inference only: the benchmark's frozen copy of the port's plain paths
(reference wetts/vits/model/{modules,attentions,normalization}.py).

Parameters keep the names and shapes of the published checkpoints, so one
state dict loads into the program and into this reference: a conv's
`weight` [O, I, K] and `bias`, or `weight_g` [O, 1, 1] and `weight_v` where
it is weight-normed (a transposed conv: [I, O, K], the norm per input
channel), LayerNorm `gamma` and `beta`. Weight norm is folded anew at every
call, from the two parameters: nothing the program derived is read.
Activations are [B, C, T]. Dropout is the identity at inference and is
left out.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def fold_weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g * v / ||v||, the norm over every axis but the first."""
    norm = torch.sqrt((v * v).sum(dim=tuple(range(1, v.ndim)), keepdim=True))
    return v * (g.reshape(-1, *([1] * (v.ndim - 1)))
                / torch.clamp_min(norm, 1e-12))


def gated(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """tanh(s[:n]) * sigmoid(s[n:]) of s = a + b over the channel axis."""
    s = a + b
    return torch.tanh(s[:, :n]) * torch.sigmoid(s[:, n:])


class _Kernel(nn.Module):
    def _init_weight(self, shape, g_len: int, weight_norm: bool):
        self.weight_norm = weight_norm
        if weight_norm:
            self.weight_g = nn.Parameter(
                torch.zeros(g_len, *([1] * (len(shape) - 1))))
            self.weight_v = nn.Parameter(torch.zeros(shape))
        else:
            self.weight = nn.Parameter(torch.zeros(shape))

    def kernel(self) -> torch.Tensor:
        if self.weight_norm:
            return fold_weight_norm(self.weight_v, self.weight_g)
        return self.weight


class Conv1d(_Kernel):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = True,
                 weight_norm: bool = False):
        super().__init__()
        self.padding, self.dilation, self.groups = padding, dilation, groups
        self._init_weight((out_channels, in_channels // groups, kernel_size),
                          out_channels, weight_norm)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.kernel(), self.bias, padding=self.padding,
                        dilation=self.dilation, groups=self.groups)


class ConvTranspose1d(_Kernel):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, weight_norm: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self._init_weight((in_channels, out_channels, kernel_size),
                          in_channels, weight_norm)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.kernel(), self.bias,
                                  stride=self.stride, padding=self.padding)


class LayerNorm(nn.Module):
    """LayerNorm over the channel axis of [B, C, T], eps 1e-5."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.layer_norm(x.transpose(1, -1), (x.shape[1],), self.gamma,
                         self.beta, 1e-5)
        return x.transpose(1, -1)


def _relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, 2L-1] -> [B, H, L, L] (attentions.py:321-340)."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1))
    x_flat = F.pad(x.reshape(b, h, l * 2 * l), (0, l - 1))
    return x_flat.reshape(b, h, l + 1, 2 * l - 1)[:, :, :l, l - 1:]


def _absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, L] -> [B, H, L, 2L-1] (attentions.py:342-358)."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1))
    x_flat = F.pad(x.reshape(b, h, l * l + l * (l - 1)), (l, 0))
    return x_flat.reshape(b, h, l, 2 * l)[:, :, :, 1:]


def _slice_relative_embeddings(emb: torch.Tensor, length: int,
                               window_size: int) -> torch.Tensor:
    """Center-pad or slice [Hr, 2w+1, D] to [Hr, 2*length-1, D]."""
    pad_length = max(length - (window_size + 1), 0)
    slice_start = max((window_size + 1) - length, 0)
    if pad_length > 0:
        emb = F.pad(emb, (0, 0, pad_length, pad_length))
    return emb[:, slice_start: slice_start + 2 * length - 1]


class MultiHeadAttention(nn.Module):
    """Self-attention with shared relative-position embeddings where
    `window_size` is set, and the -1e4 mask fill."""

    def __init__(self, channels: int, n_heads: int,
                 window_size: Optional[int] = 4):
        super().__init__()
        self.n_heads = n_heads
        self.k_channels = channels // n_heads
        self.window_size = window_size
        self.conv_q = Conv1d(channels, channels)
        self.conv_k = Conv1d(channels, channels)
        self.conv_v = Conv1d(channels, channels)
        self.conv_o = Conv1d(channels, channels)
        if window_size is not None:
            shape = (1, 2 * window_size + 1, self.k_channels)
            self.emb_rel_k = nn.Parameter(torch.zeros(shape))
            self.emb_rel_v = nn.Parameter(torch.zeros(shape))

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor
                ) -> torch.Tensor:
        b, ch, t = x.shape
        h, d = self.n_heads, self.k_channels

        def split(a):  # [B, C, T] -> [B, H, T, D]
            return a.reshape(b, h, d, t).transpose(2, 3)

        q = split(self.conv_q(x)) * (1.0 / math.sqrt(d))
        k = split(self.conv_k(x))
        v = split(self.conv_v(x))
        scores = q @ k.transpose(-2, -1)
        if self.window_size is not None:
            key_rel = _slice_relative_embeddings(self.emb_rel_k, t,
                                                 self.window_size)
            scores = scores + _relative_to_absolute(
                q @ key_rel.transpose(-2, -1)[None])
        scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = torch.softmax(scores, dim=-1)
        out = p_attn @ v
        if self.window_size is not None:
            value_rel = _slice_relative_embeddings(self.emb_rel_v, t,
                                                   self.window_size)
            out = out + _absolute_to_relative(p_attn) @ value_rel[None]
        return self.conv_o(out.transpose(2, 3).reshape(b, ch, t))


class FFN(nn.Module):
    """conv -> relu -> conv with "same" padding, masked."""

    def __init__(self, channels: int, filter_channels: int,
                 kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv_1 = Conv1d(channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, channels, kernel_size)

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        return x if k == 1 else F.pad(x, ((k - 1) // 2, k // 2))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv_1(self._pad(x * x_mask)))
        return self.conv_2(self._pad(x * x_mask)) * x_mask


class Encoder(nn.Module):
    """Post-norm relative-position transformer encoder (no speaker
    conditioning: neither configuration conditions its text encoder)."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 window_size: Optional[int] = 4):
        super().__init__()
        self.attn_layers = nn.ModuleList()
        self.norm_layers_1 = nn.ModuleList()
        self.ffn_layers = nn.ModuleList()
        self.norm_layers_2 = nn.ModuleList()
        for _ in range(n_layers):
            self.attn_layers.append(MultiHeadAttention(
                hidden_channels, n_heads, window_size))
            self.norm_layers_1.append(LayerNorm(hidden_channels))
            self.ffn_layers.append(FFN(hidden_channels, filter_channels,
                                       kernel_size))
            self.norm_layers_2.append(LayerNorm(hidden_channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        attn_mask = x_mask[:, :, :, None] * x_mask[:, :, None, :]
        x = x * x_mask
        for attn, norm1, ffn, norm2 in zip(
                self.attn_layers, self.norm_layers_1, self.ffn_layers,
                self.norm_layers_2):
            x = norm1(x + attn(x, attn_mask))
            x = norm2(x + ffn(x, x_mask))
        return x * x_mask
