"""Text encoder (prior) and posterior encoder (port of
wetts_tpu/models/encoders.py; reference wetts/vits/model/encoders.py):
- TextEncoder (:11-57): phone embedding scaled by sqrt(hidden) ->
  relative-position transformer (speaker-conditioned before its third
  block where gin_channels > 0, VITS2's use_spk_conditioned_encoder) ->
  1x1 conv to (m_p, logs_p);
- PosteriorEncoder (:60-99): 1x1 pre -> WN -> 1x1 proj to (m_q, logs_q) and
  a reparameterized sample z.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from wetts_tpu_torch.models.attention import Encoder
from wetts_tpu_torch.models.layers import Conv1d
from wetts_tpu_torch.models.wavenet import WN
from wetts_tpu_torch.ops import random
from wetts_tpu_torch.ops.masking import sequence_mask


class TextEncoder(nn.Module):
    def __init__(self, n_vocab: int, out_channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, p_dropout: float = 0.0,
                 gin_channels: int = 0):
        super().__init__()
        self.out_channels = out_channels
        self.hidden_channels = hidden_channels
        self.emb = nn.Embedding(n_vocab, hidden_channels)
        self.encoder = Encoder(hidden_channels, filter_channels, n_heads,
                               n_layers, kernel_size, p_dropout=p_dropout,
                               gin_channels=gin_channels)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                g: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ...]:
        """x [B, T] phone ids, g [B, gin, 1] or None -> (hidden [B, H, T],
        m [B, C, T], logs [B, C, T], x_mask [B, 1, T])."""
        h = self.emb(x) * math.sqrt(self.hidden_channels)  # [B, T, H]
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, None, :]
        h = self.encoder(h.transpose(1, 2) * x_mask, x_mask, g, generator)
        stats = self.proj(h) * x_mask
        m, logs = torch.split(stats, self.out_channels, dim=1)
        return h, m, logs, x_mask


class PosteriorEncoder(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.out_channels = out_channels
        self.pre = Conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor,
                g: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, ...]:
        """x [B, spec_channels, T] -> (z, m_q, logs_q [B, C, T],
        y_mask [B, 1, T]); z = (m + eps * exp(logs)) * mask."""
        x_mask = sequence_mask(x_lengths, x.shape[2])[:, None, :]
        h = self.pre(x) * x_mask
        h = self.enc(h, x_mask, g=g, generator=generator)
        stats = self.proj(h) * x_mask
        m, logs = torch.split(stats, self.out_channels, dim=1)
        noise = random.normal(m.shape, m.device, m.dtype, generator)
        z = (m + noise * torch.exp(logs)) * x_mask
        return z, m, logs, x_mask
