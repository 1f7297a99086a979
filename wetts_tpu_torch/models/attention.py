"""Relative-position transformer blocks (port of
wetts_tpu/models/attention.py; reference wetts/vits/model/attentions.py).

- MultiHeadAttention: self- or cross-attention (queries from x, keys and
  values from c), with learned relative-position embeddings where
  `window_size` is set (heads shared, or one table per head), the rel<->abs
  index shuffles (:302-358), the -1e4 mask fill (:262), the optional
  proximal bias (:360-370) and block-local masking (:263-269).
  `proximal_init` only changes an initialisation and is left out.
- FFN: "same" or causal conv padding, relu or the approximate gelu
  x * sigmoid(1.702 x) (:373-429).
- Encoder: post-norm, with the VITS2 speaker conditioning added before
  block `cond_layer_idx` (:38-48, :74-78).
- Decoder: causal self-attention and enc-dec cross-attention (:90-169).
- FFT: the causal block of the transformer flows, with WaveNet-style gated
  speaker conditioning (:551-634).

Activations are [B, C, T]; scores are in the activations' type (f32, or
bf16 in the flow's bf16 copy). Dropout (`p_dropout`) sits where the JAX
modules have it: on the attention weights, after the FFN's activation, and
on each residual branch; it is active in train() mode only and draws from
the caller's generator (ops/random.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from wetts_tpu_torch.models.layers import (
    Conv1d,
    Dense,
    LayerNorm,
    fused_add_tanh_sigmoid_multiply,
)
from wetts_tpu_torch.ops import random
from wetts_tpu_torch.ops.masking import subsequent_mask


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
    """Multi-head attention of x's queries over c's keys and values."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: Optional[int] = 4, p_dropout: float = 0.0,
                 heads_share: bool = True,
                 block_length: Optional[int] = None,
                 proximal_bias: bool = False):
        super().__init__()
        assert channels % n_heads == 0
        self.n_heads = n_heads
        self.p_dropout = p_dropout
        self.k_channels = channels // n_heads
        self.window_size = window_size
        self.block_length = block_length
        self.proximal_bias = proximal_bias
        self.conv_q = Dense(channels, channels)
        self.conv_k = Dense(channels, channels)
        self.conv_v = Dense(channels, channels)
        self.conv_o = Dense(channels, out_channels)
        if window_size is not None:
            shape = (1 if heads_share else n_heads, 2 * window_size + 1,
                     self.k_channels)
            self.emb_rel_k = nn.Parameter(torch.zeros(shape))
            self.emb_rel_v = nn.Parameter(torch.zeros(shape))

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, C, T_t] queries; c [B, C, T_s] keys and values; attn_mask
        broadcastable to [B, 1, T_t, T_s] (1 = attend)."""
        b, ch, t_t = x.shape
        t_s = c.shape[2]
        h, d = self.n_heads, self.k_channels

        def split(a, t):  # [B, C, T] -> [B, H, T, D]
            return a.reshape(b, h, d, t).transpose(2, 3)

        q = split(self.conv_q(x), t_t) * (1.0 / math.sqrt(d))
        k = split(self.conv_k(c), t_s)
        v = split(self.conv_v(c), t_s)
        scores = q @ k.transpose(-2, -1)
        if self.window_size is not None:
            assert t_s == t_t, "relative attention needs self-attention"
            key_rel = _slice_relative_embeddings(self.emb_rel_k, t_s,
                                                 self.window_size)
            scores = scores + _relative_to_absolute(
                q @ key_rel.transpose(-2, -1)[None])
        if self.proximal_bias:
            assert t_s == t_t, "the proximal bias needs self-attention"
            r = torch.arange(t_s, device=x.device, dtype=torch.float32)
            bias = -torch.log1p(torch.abs(r[None, :] - r[:, None]))
            scores = scores + bias.to(scores.dtype)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
            if self.block_length is not None:
                assert t_s == t_t, "block-local masking needs self-attention"
                pos = torch.arange(t_s, device=x.device)
                band = (pos[None, :] - pos[:, None]).abs() <= self.block_length
                scores = scores.masked_fill(~band, -1e4)
        p_attn = random.dropout(torch.softmax(scores, dim=-1),
                                self.p_dropout, self.training, generator)
        out = p_attn @ v
        if self.window_size is not None:
            value_rel = _slice_relative_embeddings(self.emb_rel_v, t_s,
                                                   self.window_size)
            out = out + _absolute_to_relative(p_attn) @ value_rel[None]
        return self.conv_o(out.transpose(2, 3).reshape(b, ch, t_t))


class FFN(nn.Module):
    """conv -> relu (or the approximate gelu) -> conv, with "same" or
    causal padding, masked (reference :373-429)."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0, activation: Optional[str] = None,
                 causal: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.p_dropout = p_dropout
        self.activation = activation
        self.causal = causal
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size)

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        if k == 1:
            return x
        if self.causal:
            return F.pad(x, (k - 1, 0))
        return F.pad(x, ((k - 1) // 2, k // 2))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.conv_1(self._pad(x * x_mask))
        if self.activation == "gelu":
            x = x * torch.sigmoid(1.702 * x)
        else:
            x = torch.relu(x)
        x = random.dropout(x, self.p_dropout, self.training, generator)
        return self.conv_2(self._pad(x * x_mask)) * x_mask


class Encoder(nn.Module):
    """Post-norm relative-position transformer encoder.

    With gin_channels > 0 (VITS2 `use_spk_conditioned_encoder`), a g passed
    to forward goes through `spk_emb_linear` and is added to x before block
    `cond_layer_idx`. The projection exists only where that block does, as
    its parameter does in the JAX package.
    """

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 window_size: Optional[int] = 4, p_dropout: float = 0.0,
                 gin_channels: int = 0, cond_layer_idx: int = 2):
        super().__init__()
        self.p_dropout = p_dropout
        self.cond_layer_idx = cond_layer_idx
        if gin_channels > 0 and cond_layer_idx < n_layers:
            self.spk_emb_linear = nn.Linear(gin_channels, hidden_channels)
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
                g: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, C, T]; x_mask [B, 1, T]; g [B, gin, 1] or None."""
        attn_mask = x_mask[:, :, :, None] * x_mask[:, :, None, :]
        x = x * x_mask

        def drop(y):
            return random.dropout(y, self.p_dropout, self.training,
                                  generator)

        for i, (attn, norm1, ffn, norm2) in enumerate(zip(
                self.attn_layers, self.norm_layers_1, self.ffn_layers,
                self.norm_layers_2)):
            if (i == self.cond_layer_idx and g is not None
                    and hasattr(self, "spk_emb_linear")):
                g_proj = self.spk_emb_linear(g.transpose(1, 2))
                x = (x + g_proj.transpose(1, 2)) * x_mask
            x = norm1(x + drop(attn(x, x, attn_mask, generator)))
            x = norm2(x + drop(ffn(x, x_mask, generator)))
        return x * x_mask


class Decoder(nn.Module):
    """Causal self-attention, enc-dec cross-attention and a causal FFN per
    layer, post-norm (reference :90-169). Nothing in the package calls it;
    it is ported with the rest of the module."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 p_dropout: float = 0.0, proximal_bias: bool = False):
        super().__init__()
        self.p_dropout = p_dropout
        self.self_attn_layers = nn.ModuleList()
        self.norm_layers_0 = nn.ModuleList()
        self.encdec_attn_layers = nn.ModuleList()
        self.norm_layers_1 = nn.ModuleList()
        self.ffn_layers = nn.ModuleList()
        self.norm_layers_2 = nn.ModuleList()
        for _ in range(n_layers):
            self.self_attn_layers.append(MultiHeadAttention(
                hidden_channels, hidden_channels, n_heads, None, p_dropout,
                proximal_bias=proximal_bias))
            self.norm_layers_0.append(LayerNorm(hidden_channels))
            self.encdec_attn_layers.append(MultiHeadAttention(
                hidden_channels, hidden_channels, n_heads, None, p_dropout))
            self.norm_layers_1.append(LayerNorm(hidden_channels))
            self.ffn_layers.append(FFN(
                hidden_channels, hidden_channels, filter_channels,
                kernel_size, p_dropout, causal=True))
            self.norm_layers_2.append(LayerNorm(hidden_channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                h: torch.Tensor, h_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, C, T] with x_mask [B, 1, T]; h [B, C, T_h], the encoder's
        output, with h_mask [B, 1, T_h]."""
        self_attn_mask = subsequent_mask(x.shape[2], x.device)
        encdec_mask = h_mask[:, :, None, :] * x_mask[:, :, :, None]
        x = x * x_mask

        def drop(y):
            return random.dropout(y, self.p_dropout, self.training,
                                  generator)

        for self_attn, norm0, encdec, norm1, ffn, norm2 in zip(
                self.self_attn_layers, self.norm_layers_0,
                self.encdec_attn_layers, self.norm_layers_1,
                self.ffn_layers, self.norm_layers_2):
            x = norm0(x + drop(self_attn(x, x, self_attn_mask, generator)))
            x = norm1(x + drop(encdec(x, h, encdec_mask, generator)))
            x = norm2(x + drop(ffn(x, x_mask, generator)))
        return x * x_mask


class FFT(nn.Module):
    """The causal transformer block of the transformer flows (reference
    :551-634): causal self-attention and a causal FFN per layer, post-norm.

    The self-attention mask is the causal mask alone, with no padding mask.
    With gin_channels > 0 and a g, each layer first replaces x by the gated
    tanh/sigmoid of cond_pre(x) plus its slice of cond_layer(g); cond_pre is
    one conv shared by every layer.
    """

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int = 1, kernel_size: int = 1,
                 p_dropout: float = 0.0, proximal_bias: bool = False,
                 gin_channels: int = 0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.p_dropout = p_dropout
        if gin_channels > 0:
            self.cond_layer = Conv1d(gin_channels,
                                     2 * hidden_channels * n_layers, 1,
                                     weight_norm=True)
            self.cond_pre = Conv1d(hidden_channels, 2 * hidden_channels, 1)
        self.self_attn_layers = nn.ModuleList()
        self.norm_layers_0 = nn.ModuleList()
        self.ffn_layers = nn.ModuleList()
        self.norm_layers_1 = nn.ModuleList()
        for _ in range(n_layers):
            self.self_attn_layers.append(MultiHeadAttention(
                hidden_channels, hidden_channels, n_heads, None, p_dropout,
                proximal_bias=proximal_bias))
            self.norm_layers_0.append(LayerNorm(hidden_channels))
            self.ffn_layers.append(FFN(
                hidden_channels, hidden_channels, filter_channels,
                kernel_size, p_dropout, causal=True))
            self.norm_layers_1.append(LayerNorm(hidden_channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, H, T]; x_mask [B, 1, T]; g [B, gin, 1] or None."""
        hc = self.hidden_channels
        g_all = self.cond_layer(g) if (
            g is not None and hasattr(self, "cond_layer")) else None
        self_attn_mask = subsequent_mask(x.shape[2], x.device)
        x = x * x_mask

        def drop(y):
            return random.dropout(y, self.p_dropout, self.training,
                                  generator)

        for i, (self_attn, norm0, ffn, norm1) in enumerate(zip(
                self.self_attn_layers, self.norm_layers_0, self.ffn_layers,
                self.norm_layers_1)):
            if g_all is not None:
                x = fused_add_tanh_sigmoid_multiply(
                    self.cond_pre(x), g_all[:, 2 * hc * i: 2 * hc * (i + 1)],
                    hc)
            x = norm0(x + drop(self_attn(x, x, self_attn_mask, generator)))
            x = norm1(x + drop(ffn(x, x_mask, generator)))
        return x * x_mask
