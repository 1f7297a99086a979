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

For inference on a card (f32, no gradient recorded, nothing exporting,
compiling or tracing) the backbone runs on channels-last activations
through the hand-written kernels of `models/vocos_backbone.py` (split-TF32
`wgmma` GEMMs with the GELU and the layer scale and residual in their
epilogues, and one row kernel for the depthwise conv and each LayerNorm);
widths those do not take raise there (`vocos_backbone.check_widths`).
Every other call takes the modules (training, the CPU, `torch.export`). Given a
StageTimes, every decode counts `vocos_fused`: 1 where it took the kernels,
else 0.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from wetts_tpu_torch.models import vocos_backbone
from wetts_tpu_torch.models.layers import Conv1d, DerivedWeights, LayerNorm
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


class VocosGenerator(DerivedWeights):
    precisions = ("f32",)

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

    def packed_weights(self) -> List[torch.Tensor]:
        """The 1x1 convs' weights packed for the kernels
        (`vocos_backbone.pack_weight`) in the backbone's order, derived from
        those weights alone and kept by the rule of `DerivedWeights`."""
        convs = vocos_backbone.convs(self)
        return self.derived(
            "packed", lambda: [(c, "weight") for c in convs],
            lambda: [vocos_backbone.pack_weight(c.weight[:, :, 0])
                     for c in convs])

    def prepare(self, precision: str) -> None:
        """Raises ValueError unless `precision` is one of `precisions`."""
        if precision not in self.precisions:
            raise ValueError(f"the Vocos decoder runs in f32 only, not "
                             f"{precision!r}")

    def backbone_modules(self, x: torch.Tensor,
                         g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The module path of the in_conv through the out_conv: x [B, C, T]
        -> [B, out_channels, T + 1]."""
        x = self.in_conv(F.pad(x, (1, 0), mode="reflect"))
        if g is not None and hasattr(self, "cond"):
            x = x + self.cond(g)
        x = self.norm_pre(x)
        for layer in self.layers:
            x = layer(x)
        return self.out_conv(self.norm_post(x))

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None,
                precision: str = "f32",
                stages: Optional[StageTimes] = None) -> torch.Tensor:
        """x [B, C, T] latent, g [B, gin, 1] or None -> [B, 1, T * hop]."""
        self.prepare(precision)

        def stage(name):
            return (contextlib.nullcontext() if stages is None
                    else stages.device_stage(name, x.device))

        fused = vocos_backbone.applies(self, x)
        if stages is not None:
            stages.count("vocos_fused", int(fused))
        with stage("vocos"):
            x = (vocos_backbone.backbone(self, x, g) if fused
                 else self.backbone_modules(x, g).transpose(1, 2))
        with stage("istft"):
            # x [B, T + 1, out_channels], channels last on either path
            log_mag, phase = torch.chunk(x, 2, dim=2)
            mag = torch.clamp(torch.exp(log_mag), max=1e2)
            audio = istft(mag * torch.cos(phase), mag * torch.sin(phase),
                          *self.istft_args)
        return audio[:, None, :]
