"""GAN discriminators (port of wetts_tpu/models/discriminators.py;
reference wetts/vits/model/discriminators.py):

- DiscriminatorP (:21-95): reflect-pad the waveform to a multiple of the
  period, fold it to 2D, a stack of (k, 1)-kernel strided convs,
- DiscriminatorS (:98-124): a grouped 1D conv stack,
- DiscriminatorR (:127-225): DC removal and peak normalisation, a complex
  STFT (`torch.stft`, cuFFT on the GPU) as two channels, 2D convs over five
  frequency bands, concatenated along frequency,
- MultiPeriodDiscriminator (:228-254) = S + P(2, 3, 5, 7, 11),
- MultiPeriodMultiResolutionDiscriminator (:256-283) = R(2048, 1024, 512)
  + P(2, 3, 5, 7, 11),
- DurationDiscriminatorV1 / V2 (:287-449): VITS2's discriminator of
  log-durations given the (detached) text hidden states,
- WavLMDiscriminator (:452-498): a 1D conv stack over the stacked hidden
  states of a frozen WavLM (the SLM discriminator).

Waveforms are [B, T, 1], as in the JAX package; every waveform
sub-discriminator returns (flattened logits [B, N], feature maps). Feature
maps come back channel-last ([B, T', C] and [B, H, W, C], H the frames and
W the period or the frequency bins) so they compare one to one with the JAX
package's. The duration and WavLM discriminators take and return the JAX
layout too: hidden states [B, T, C], masks and durations [B, T, 1],
probabilities [B, T, 1]; WavLM features [B, T, C], logits [B, T].
Parameters keep the reference's state_dict names
(`discriminators.{i}.convs.{j}`, `discriminators.{i}.band_convs.{b}.{j}`,
`conv_post`; `output_layer.0` for the duration discriminators' linear
layer; `pre`, `convs.{0,1,2}`, `conv_post` for the WavLM discriminator).
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
    LayerNorm,
    get_padding,
)
from wetts_tpu_torch.ops.spectral import complex_spectrogram


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


class DiscriminatorR(nn.Module):
    """The resolution discriminator of one STFT size."""

    BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))
    # (kernel, stride, padding) per conv of a band, over (frames, bins)
    CONVS = (((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)),
             ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)),
             ((3, 3), (1, 1), (1, 1)))

    def __init__(self, window_length: int, channels: int = 32,
                 hop_factor: float = 0.25):
        super().__init__()
        self.window_length = window_length
        self.hop_length = int(window_length * hop_factor)
        n_bins = window_length // 2 + 1
        self.bands = [(int(lo * n_bins), int(hi * n_bins))
                      for lo, hi in self.BANDS]
        self.band_convs = nn.ModuleList([nn.ModuleList([
            Conv2d(2 if j == 0 else channels, channels, k, s, p,
                   weight_norm=True)
            for j, (k, s, p) in enumerate(self.CONVS)])
            for _ in self.bands])
        self.conv_post = Conv2d(channels, 1, (3, 3), (1, 1), (1, 1),
                                weight_norm=True)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x [B, T, 1] -> (logits [B, N], feature maps [B, frames, W, C])."""
        b = x.shape[0]
        y = x[..., 0]
        y = y - torch.mean(y, dim=-1, keepdim=True)
        y = 0.8 * y / (torch.amax(torch.abs(y), dim=-1, keepdim=True) + 1e-9)
        spec = complex_spectrogram(y, self.window_length, self.hop_length)
        fmap, outs = [], []
        for (lo, hi), convs in zip(self.bands, self.band_convs):
            h = spec[..., lo:hi]
            for j, conv in enumerate(convs):
                h = F.leaky_relu(conv(h), 0.1)
                if j > 0:
                    fmap.append(h.permute(0, 2, 3, 1))
            outs.append(h)
        x = self.conv_post(torch.cat(outs, dim=-1))  # along frequency
        fmap.append(x.permute(0, 2, 3, 1))
        return fmap[-1].reshape(b, -1), fmap


class _Ensemble(nn.Module):
    """Sub-discriminators applied in turn to the real and the generated
    waveform."""

    def __init__(self, discriminators: Sequence[nn.Module]):
        super().__init__()
        self.discriminators = nn.ModuleList(discriminators)

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


class MultiPeriodDiscriminator(_Ensemble):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__([DiscriminatorS()]
                         + [DiscriminatorP(p) for p in periods])


class MultiPeriodMultiResolutionDiscriminator(_Ensemble):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 fft_sizes: Sequence[int] = (2048, 1024, 512)):
        super().__init__([DiscriminatorR(w) for w in fft_sizes]
                         + [DiscriminatorP(p) for p in periods])


def _bct(x: torch.Tensor) -> torch.Tensor:
    """[B, T, C] <-> [B, C, T]."""
    return x.transpose(1, 2)


class DurationDiscriminatorV1(nn.Module):
    """VITS2 duration discriminator, v1: convs without norms. It keeps the
    `pre_out_norm_*` parameters that the reference stores and its forward
    never uses, so that a reference `DUR_*.pth` loads. `p_dropout` and
    `gin_channels` are taken, as by the reference's constructor, and unused,
    as in the JAX package."""

    normed = False  # V2: relu + LayerNorm after every conv

    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float = 0.0,
                 gin_channels: int = 0):
        super().__init__()
        fc, k, pad = filter_channels, kernel_size, kernel_size // 2
        self.conv_1 = Conv1d(in_channels, fc, k, padding=pad)
        self.conv_2 = Conv1d(fc, fc, k, padding=pad)
        if self.normed:
            self.norm_1 = LayerNorm(fc)
            self.norm_2 = LayerNorm(fc)
        self.dur_proj = Conv1d(1, fc, 1)
        self.pre_out_conv_1 = Conv1d(2 * fc, fc, k, padding=pad)
        self.pre_out_norm_1 = LayerNorm(fc)
        self.pre_out_conv_2 = Conv1d(fc, fc, k, padding=pad)
        self.pre_out_norm_2 = LayerNorm(fc)
        self.output_layer = nn.Sequential(nn.Linear(fc, 1), nn.Sigmoid())

    def _act(self, h: torch.Tensor, norm: str) -> torch.Tensor:
        """V2: relu, then the LayerNorm named `norm`; V1: h as it is."""
        return getattr(self, norm)(F.relu(h)) if self.normed else h

    def _probability(self, x, x_mask, dur):
        h = torch.cat([x, self.dur_proj(dur)], dim=1)
        h = self._act(self.pre_out_conv_1(h * x_mask), "pre_out_norm_1")
        h = self._act(self.pre_out_conv_2(h * x_mask), "pre_out_norm_2")
        return self.output_layer(_bct(h * x_mask))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                dur_r: torch.Tensor, dur_hat: torch.Tensor
                ) -> List[torch.Tensor]:
        """x [B, T, C] (detached here), x_mask [B, T, 1], the aligned and the
        predicted log-durations [B, T, 1] -> their probabilities of being
        real, each [B, T, 1]."""
        x, x_mask = _bct(x.detach()), _bct(x_mask)
        x = self._act(self.conv_1(x * x_mask), "norm_1")
        x = self._act(self.conv_2(x * x_mask), "norm_2")
        return [self._probability(x, x_mask, _bct(d))
                for d in (dur_r, dur_hat)]


class DurationDiscriminatorV2(DurationDiscriminatorV1):
    """VITS2 duration discriminator, v2: relu + LayerNorm after every
    conv."""

    normed = True


class WavLMDiscriminator(nn.Module):
    """Discriminator over stacked frozen-WavLM hidden states: a weight-normed
    1x1 conv to `initial_channel`, three kernel-5 convs (x2, x4, x4
    channels) each followed by leaky ReLU, a kernel-3 conv to one
    channel."""

    def __init__(self, slm_hidden: int = 768, slm_layers: int = 13,
                 initial_channel: int = 64):
        super().__init__()
        ic = initial_channel
        self.pre = Conv1d(slm_hidden * slm_layers, ic, 1, weight_norm=True)
        self.convs = nn.ModuleList([
            Conv1d(c_in, c_out, 5, padding=2, weight_norm=True)
            for c_in, c_out in ((ic, ic * 2), (ic * 2, ic * 4),
                                (ic * 4, ic * 4))])
        self.conv_post = Conv1d(ic * 4, 1, 3, padding=1, weight_norm=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, slm_hidden * slm_layers] -> logits [B, T]."""
        x = self.pre(_bct(x))
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
        return self.conv_post(x).flatten(1)
