"""Relative-position transformer encoder (port of wetts_tpu/models/attention.py
for the VITS1 text encoder; reference wetts/vits/model/attentions.py).

MultiHeadAttention with learned relative-position embeddings (window 4,
heads shared), the rel<->abs index shuffles (:302-358) and the -1e4 mask fill
(:262); FFN with "same" conv padding and relu; the post-norm Encoder.
Activations are [B, C, T]; scores are f32. Dropout (`p_dropout`) sits where
the JAX modules have it: on the attention weights, after the FFN's relu,
and on each residual branch of the Encoder; it is active in train() mode
only and draws from the caller's generator (ops/random.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from wetts_tpu_torch.models.layers import Conv1d, Dense, LayerNorm
from wetts_tpu_torch.ops import random


def _relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, 2L-1] -> [B, H, L, L] (reference :321-340)."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1))
    x_flat = F.pad(x.reshape(b, h, l * 2 * l), (0, l - 1))
    return x_flat.reshape(b, h, l + 1, 2 * l - 1)[:, :, :l, l - 1:]


def _absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, L] -> [B, H, L, 2L-1] (reference :342-358)."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1))
    x_flat = F.pad(x.reshape(b, h, l * l + l * (l - 1)), (l, 0))
    return x_flat.reshape(b, h, l, 2 * l)[:, :, :, 1:]


def _slice_relative_embeddings(emb: torch.Tensor, length: int,
                               window_size: int) -> torch.Tensor:
    """Center-pad/slice [Hr, 2w+1, D] -> [Hr, 2*length-1, D] (:302-319)."""
    pad_length = max(length - (window_size + 1), 0)
    slice_start = max((window_size + 1) - length, 0)
    if pad_length > 0:
        emb = F.pad(emb, (0, 0, pad_length, pad_length))
    return emb[:, slice_start: slice_start + 2 * length - 1]


class MultiHeadAttention(nn.Module):
    """Self-attention with shared relative-position embeddings."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: Optional[int] = 4, p_dropout: float = 0.0):
        super().__init__()
        assert channels % n_heads == 0
        self.n_heads = n_heads
        self.p_dropout = p_dropout
        self.k_channels = channels // n_heads
        self.window_size = window_size
        self.conv_q = Dense(channels, channels)
        self.conv_k = Dense(channels, channels)
        self.conv_v = Dense(channels, channels)
        self.conv_o = Dense(channels, out_channels)
        if window_size is not None:
            n = 2 * window_size + 1
            self.emb_rel_k = nn.Parameter(torch.zeros(1, n, self.k_channels))
            self.emb_rel_v = nn.Parameter(torch.zeros(1, n, self.k_channels))

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, C, T]; attn_mask [B, 1, T, T] (1 = attend)."""
        b, c, t = x.shape
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
                q @ key_rel.transpose(-2, -1)[:, None])
        scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = random.dropout(torch.softmax(scores, dim=-1),
                                self.p_dropout, self.training, generator)
        out = p_attn @ v
        if self.window_size is not None:
            value_rel = _slice_relative_embeddings(self.emb_rel_v, t,
                                                   self.window_size)
            out = out + _absolute_to_relative(p_attn) @ value_rel[:, None]
        return self.conv_o(out.transpose(2, 3).reshape(b, c, t))


class FFN(nn.Module):
    """conv -> relu -> conv with "same" padding, masked (reference
    :373-429)."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.kernel_size = kernel_size
        self.p_dropout = p_dropout
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size)

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_size == 1:
            return x
        return F.pad(x, ((self.kernel_size - 1) // 2, self.kernel_size // 2))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.relu(self.conv_1(self._pad(x * x_mask)))
        x = random.dropout(x, self.p_dropout, self.training, generator)
        return self.conv_2(self._pad(x * x_mask)) * x_mask


class Encoder(nn.Module):
    """Post-norm relative-position transformer encoder."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 window_size: Optional[int] = 4, p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.attn_layers = nn.ModuleList()
        self.norm_layers_1 = nn.ModuleList()
        self.ffn_layers = nn.ModuleList()
        self.norm_layers_2 = nn.ModuleList()
        for _ in range(n_layers):
            self.attn_layers.append(MultiHeadAttention(
                hidden_channels, hidden_channels, n_heads, window_size,
                p_dropout))
            self.norm_layers_1.append(LayerNorm(hidden_channels))
            self.ffn_layers.append(FFN(hidden_channels, hidden_channels,
                                       filter_channels, kernel_size,
                                       p_dropout))
            self.norm_layers_2.append(LayerNorm(hidden_channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, C, T]; x_mask [B, 1, T]."""
        attn_mask = x_mask[:, :, :, None] * x_mask[:, :, None, :]
        x = x * x_mask

        def drop(y):
            return random.dropout(y, self.p_dropout, self.training,
                                  generator)

        for attn, norm1, ffn, norm2 in zip(
                self.attn_layers, self.norm_layers_1, self.ffn_layers,
                self.norm_layers_2):
            x = norm1(x + drop(attn(x, attn_mask, generator)))
            x = norm2(x + drop(ffn(x, x_mask, generator)))
        return x * x_mask
