"""Text encoder, the prior side of VITS (port of wetts_tpu/models/encoders.py;
reference wetts/vits/model/encoders.py:11-57): phone embedding scaled by
sqrt(hidden) -> relative-position transformer -> 1x1 conv to (m_p, logs_p).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from wetts_tpu_torch.models.attention import Encoder
from wetts_tpu_torch.models.layers import Conv1d
from wetts_tpu_torch.ops.masking import sequence_mask


class TextEncoder(nn.Module):
    def __init__(self, n_vocab: int, out_channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int):
        super().__init__()
        self.out_channels = out_channels
        self.hidden_channels = hidden_channels
        self.emb = nn.Embedding(n_vocab, hidden_channels)
        self.encoder = Encoder(hidden_channels, filter_channels, n_heads,
                               n_layers, kernel_size)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
        """x [B, T] phone ids -> (hidden [B, H, T], m [B, C, T],
        logs [B, C, T], x_mask [B, 1, T])."""
        h = self.emb(x) * math.sqrt(self.hidden_channels)  # [B, T, H]
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, None, :]
        h = self.encoder(h.transpose(1, 2) * x_mask, x_mask)
        stats = self.proj(h) * x_mask
        m, logs = torch.split(stats, self.out_channels, dim=1)
        return h, m, logs, x_mask
