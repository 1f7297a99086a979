"""HiFi-GAN waveform decoder (port of wetts_tpu/models/hifigan.py; reference
wetts/vits/model/decoders.py:15-218).

conv_pre(7) [+ cond(g)] -> per upsample stage: leaky_relu(0.1) ->
weight-normed ConvTranspose upsample -> MRF stage (the mean of the resblock
branches) -> leaky_relu(0.01, torch's default, decoders.py:78) ->
conv_post(7, no bias) -> tanh.

Every MRF stage goes through `mrf.mrf_stage`, which launches kernel K1 on the
GPU. conv_pre, cond, the upsample convs and conv_post lay outside any Pallas
kernel in the JAX package and stay F.conv1d / F.conv_transpose1d.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wetts_tpu_torch.models.layers import (
    LRELU_SLOPE,
    Conv1d,
    ConvTranspose1d,
    get_padding,
)
from wetts_tpu_torch.models.mrf import Branch, check_stage, mrf_stage


def _forget_stages(module: "Generator", _incompatible_keys) -> None:
    module._checked_stages = None


class ResBlock1(nn.Module):
    """Parameters of one ResBlock1 branch: per dilation d, a dilated conv
    (convs1) and a plain conv (convs2), weight-normed."""

    def __init__(self, channels: int, kernel_size: int,
                 dilation: Sequence[int]):
        super().__init__()
        self.convs1 = nn.ModuleList([
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=get_padding(kernel_size, d), weight_norm=True)
            for d in dilation])
        self.convs2 = nn.ModuleList([
            Conv1d(channels, channels, kernel_size,
                   padding=get_padding(kernel_size, 1), weight_norm=True)
            for _ in dilation])

    def folded_convs(self) -> Branch:
        out = []
        for c1, c2 in zip(self.convs1, self.convs2):
            out += [(c1.weight, c1.bias), (c2.weight, c2.bias)]
        return out


class ResBlock2(nn.Module):
    """Parameters of one ResBlock2 branch: one dilated conv per dilation."""

    def __init__(self, channels: int, kernel_size: int,
                 dilation: Sequence[int]):
        super().__init__()
        self.convs = nn.ModuleList([
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=get_padding(kernel_size, d), weight_norm=True)
            for d in dilation])

    def folded_convs(self) -> Branch:
        return [(c.weight, c.bias) for c in self.convs]


class Generator(nn.Module):
    """Latent [B, C_inter, T] -> waveform [B, 1, T * prod(upsample_rates)]."""

    def __init__(self, initial_channel: int, resblock: str,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int],
                 upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int],
                 gin_channels: int = 0):
        super().__init__()
        self.resblock = resblock
        self.kernel_sizes = tuple(resblock_kernel_sizes)
        self.dilations = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7,
                               padding=3)
        if gin_channels != 0:
            self.cond = Conv1d(gin_channels, upsample_initial_channel, 1)
        res_cls = ResBlock1 if resblock == "1" else ResBlock2
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for u, k in zip(upsample_rates, upsample_kernel_sizes):
            self.ups.append(ConvTranspose1d(ch, ch // 2, k, u,
                                            padding=(k - u) // 2,
                                            weight_norm=True))
            ch //= 2
            for rk, rd in zip(self.kernel_sizes, self.dilations):
                self.resblocks.append(res_cls(ch, rk, rd))
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)
        self._checked_stages: Optional[List[List[Branch]]] = None
        self.register_load_state_dict_post_hook(_forget_stages)

    def stage_convs(self, i: int) -> List[Branch]:
        """Stage i's folded (weight, bias) pairs, one list per branch."""
        n = len(self.kernel_sizes)
        return [rb.folded_convs() for rb in self.resblocks[i * n:(i + 1) * n]]

    def checked_stages(self) -> List[List[Branch]]:
        """Every stage's folded pairs, passed through `check_stage` once and
        kept until the module's tensors are moved, cast or reloaded (folding
        writes the kept tensors in place)."""
        if self._checked_stages is None:
            stages = [self.stage_convs(i) for i in range(len(self.ups))]
            for stage in stages:
                check_stage(stage, self.resblock, self.kernel_sizes,
                            self.dilations)
            self._checked_stages = stages
        return self._checked_stages

    def _apply(self, fn, *args, **kwargs):
        self._checked_stages = None
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = self.conv_pre(x)
        if g is not None and hasattr(self, "cond"):
            x = x + self.cond(g)
        for up, stage in zip(self.ups, self.checked_stages()):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            h = mrf_stage(x.transpose(1, 2).contiguous(), stage, self.resblock,
                          self.kernel_sizes, self.dilations, checked=True)
            x = h.transpose(1, 2)
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)
