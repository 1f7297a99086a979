"""The Vocos decoder (port of wetts_tpu/models/vocos.py; reference
wetts/vits/model/decoders.py:221-308): a reflection pad of one frame on the
left -> 1x1 in_conv (+ the speaker's 1x1 cond) -> LayerNorm -> N ConvNeXt
layers (depthwise conv 3, LayerNorm, pointwise conv -> exact gelu ->
pointwise conv, a per-channel layer scale initialised to 1/N, residual) ->
LayerNorm -> 1x1 out_conv to log-magnitude and phase -> exp clamped at 1e2
-> iSTFT (ops/spectral.py). Activations are [B, C, T]; a latent of T frames
gives T * hop samples. It runs in f32 only: the decoder has no reduced
route, and asking for one raises. Given a StageTimes, the backbone (the
in_conv to the out_conv) and the iSTFT (magnitude and phase on) are its
device stages `vocos` and `istft`.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from wetts_tpu_torch.models.layers import Conv1d, LayerNorm
from wetts_tpu_torch.ops.spectral import istft
from wetts_tpu_torch.utils.profiling import StageTimes


class ConvNeXtLayer(nn.Module):
    def __init__(self, channels: int, h_channels: int, scale: float):
        super().__init__()
        self.dw_conv = Conv1d(channels, channels, 3, padding=1,
                              groups=channels)
        self.norm = LayerNorm(channels)
        self.pw_conv1 = Conv1d(channels, h_channels, 1)
        self.pw_conv2 = Conv1d(h_channels, channels, 1)
        self.scale = nn.Parameter(torch.full((channels,), scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pw_conv1(self.norm(self.dw_conv(x)))
        h = self.pw_conv2(F.gelu(h))
        return x + self.scale[:, None] * h


class VocosGenerator(nn.Module):
    def __init__(self, in_channels: int, channels: int, h_channels: int,
                 out_channels: int, num_layers: int, istft_n_fft: int = 1024,
                 istft_hop_length: int = 256, istft_win_length: int = 1024,
                 gin_channels: int = 0):
        super().__init__()
        self.istft_args = (istft_n_fft, istft_hop_length, istft_win_length)
        self.in_conv = Conv1d(in_channels, channels, 1)
        if gin_channels > 0:
            self.cond = Conv1d(gin_channels, channels, 1)
        self.norm_pre = LayerNorm(channels)
        self.layers = nn.ModuleList(
            ConvNeXtLayer(channels, h_channels, 1.0 / num_layers)
            for _ in range(num_layers))
        self.norm_post = LayerNorm(channels)
        self.out_conv = Conv1d(channels, out_channels, 1)

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None,
                precision: str = "f32",
                stages: Optional[StageTimes] = None) -> torch.Tensor:
        """x [B, C, T] latent, g [B, gin, 1] or None -> [B, 1, T * hop]."""
        if precision != "f32":
            raise ValueError(f"the Vocos decoder runs in f32 only, not "
                             f"{precision!r}")

        def stage(name):
            return (contextlib.nullcontext() if stages is None
                    else stages.device_stage(name, x.device))

        with stage("vocos"):
            x = self.in_conv(F.pad(x, (1, 0), mode="reflect"))
            if g is not None and hasattr(self, "cond"):
                x = x + self.cond(g)
            x = self.norm_pre(x)
            for layer in self.layers:
                x = layer(x)
            x = self.out_conv(self.norm_post(x))
        with stage("istft"):
            log_mag, phase = torch.chunk(x, 2, dim=1)
            mag = torch.clamp(torch.exp(log_mag), max=1e2)
            audio = istft((mag * torch.cos(phase)).transpose(1, 2),
                          (mag * torch.sin(phase)).transpose(1, 2),
                          *self.istft_args)
        return audio[:, None, :]
