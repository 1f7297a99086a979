"""The prior flow (port of wetts_tpu/models/flows.py; reference
wetts/vits/model/flows.py and modules.py:98-106): mean-only affine couplings
over channel halves interleaved with flips.

- ResidualCouplingLayer (:457-516), the VITS1 coupling: pre -> WN -> post;
- the VITS2 transformer couplings that `transformer_flow_type` selects
  (:7-13): `pre_conv` (ResidualCouplingTransformersLayer, :89-176),
  `pre_conv2` (ResidualCouplingTransformersLayer2, :16-86), `fft`
  (FFTransformerCouplingLayer, :179-238) and the two mono types
  (MonoTransformerFlowLayer, :241-324), assembled by ResidualCouplingBlock
  (:327-454).

Both directions are differentiable and masked as the JAX package masks
them; voice conversion runs the stack forward, synthesis in reverse. Every
coupling is mean-only, so its log-det is 0 (the mono post-residual layer's
forward log-det is not; the stack never returns one, as the JAX stack drops
it), and the KL loss uses none: no direction returns one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from wetts_tpu_torch.models.attention import FFT, Encoder
from wetts_tpu_torch.models.layers import Conv1d
from wetts_tpu_torch.models.wavenet import WN

AVAILABLE_FLOW_TYPES = (
    "pre_conv",
    "pre_conv2",
    "fft",
    "mono_layer_inter_residual",
    "mono_layer_post_residual",
)


class Flip(nn.Module):
    """Parameterless flip of the channel axis."""

    def forward(self, x, x_mask, g=None, reverse=False, generator=None):
        return torch.flip(x, dims=[1])


class AffineCoupling(nn.Module):
    """The coupling over channel halves: x1 shifted (and, unless
    mean-only, scaled) by the stats that `post` predicts from the
    subclass's `_hidden(x0)`."""

    def __init__(self, channels: int, mean_only: bool):
        super().__init__()
        assert channels % 2 == 0
        self.half_channels = channels // 2
        self.mean_only = mean_only

    def _post(self, hidden_channels: int) -> Conv1d:
        return Conv1d(hidden_channels,
                      self.half_channels * (2 - self.mean_only), 1)

    def _stats(self, h: torch.Tensor, x_mask: torch.Tensor):
        stats = self.post(h) * x_mask
        if self.mean_only:
            return stats, torch.zeros_like(stats)
        return torch.split(stats, self.half_channels, dim=1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, reverse: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, C, T] -> the coupled x."""
        x0, x1 = torch.split(x, self.half_channels, dim=1)
        m, logs = self._stats(self._hidden(x0, x_mask, g, generator), x_mask)
        if not reverse:
            x1 = m + x1 * torch.exp(logs) * x_mask
        else:
            x1 = (x1 - m) * torch.exp(-logs) * x_mask
        return torch.cat([x0, x1], dim=1)


class ResidualCouplingLayer(AffineCoupling):
    """VITS1: pre -> WN -> post on x0."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 mean_only: bool = True):
        super().__init__(channels, mean_only)
        self.pre = Conv1d(self.half_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.post = self._post(hidden_channels)

    def _hidden(self, x0, x_mask, g, generator):
        return self.enc(self.pre(x0) * x_mask, x_mask, g=g,
                        generator=generator)


def _pre_transformer(channels: int) -> Encoder:
    """The 2-layer, 2-head, window-free encoder the `pre_conv` and mono
    layers put on x0 (reference :107-116, kernel 3, p_dropout 0.1)."""
    return Encoder(channels, channels, n_heads=2, n_layers=2, kernel_size=3,
                   window_size=None, p_dropout=0.1)


class ResidualCouplingTransformersLayer(AffineCoupling):
    """`pre_conv`: x0 + transformer(x0) -> pre -> WN -> post. The
    reference's unused `post_transformer` is not built (its tensors are
    dropped by the weight converter)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 mean_only: bool = True):
        super().__init__(channels, mean_only)
        self.pre_transformer = _pre_transformer(self.half_channels)
        self.pre = Conv1d(self.half_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.post = self._post(hidden_channels)

    def _hidden(self, x0, x_mask, g, generator):
        x0_ = self.pre_transformer(x0 * x_mask, x_mask,
                                   generator=generator) + x0
        return self.enc(self.pre(x0_) * x_mask, x_mask, g=g,
                        generator=generator)


class ResidualCouplingTransformersLayer2(AffineCoupling):
    """`pre_conv2`: pre -> h + transformer(h) -> WN -> post, the
    transformer one relative-position layer (window 4) at the hidden
    width."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 mean_only: bool = True):
        super().__init__(channels, mean_only)
        self.pre = Conv1d(self.half_channels, hidden_channels, 1)
        self.pre_transformer = Encoder(hidden_channels, hidden_channels,
                                       n_heads=2, n_layers=1,
                                       kernel_size=kernel_size)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.post = self._post(hidden_channels)

    def _hidden(self, x0, x_mask, g, generator):
        h = self.pre(x0) * x_mask
        h = h + self.pre_transformer(h * x_mask, x_mask, generator=generator)
        return self.enc(h, x_mask, g=g, generator=generator)


class FFTransformerCouplingLayer(AffineCoupling):
    """`fft`: pre -> h + FFT(h) -> post, the causal FFT block (filter 768)
    as the coupling net, speaker-conditioned inside."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 n_layers: int, n_heads: int = 2, filter_channels: int = 768,
                 gin_channels: int = 0, mean_only: bool = True):
        super().__init__(channels, mean_only)
        self.pre = Conv1d(self.half_channels, hidden_channels, 1)
        self.enc = FFT(hidden_channels, filter_channels, n_heads, n_layers,
                       kernel_size, gin_channels=gin_channels)
        self.post = self._post(hidden_channels)

    def _hidden(self, x0, x_mask, g, generator):
        h = self.pre(x0) * x_mask
        return self.enc(h, x_mask, g=g, generator=generator) + h


class MonoTransformerFlowLayer(AffineCoupling):
    """The mono-layer transformer flow, unconditioned (reference
    :241-324). `residual_connection=False` (mono_layer_inter_residual):
    x0 + transformer(x0) -> post. `True` (mono_layer_post_residual): the
    coupling is added to its input, so forward returns x + coupled(x) and
    reverse halves x0 and divides x1 - m by 1 + exp(-logs)."""

    def __init__(self, channels: int, mean_only: bool = True,
                 residual_connection: bool = False):
        super().__init__(channels, mean_only)
        self.residual_connection = residual_connection
        self.pre_transformer = _pre_transformer(self.half_channels)
        self.post = self._post(self.half_channels)

    def _hidden(self, x0, x_mask, g, generator):
        x0_ = self.pre_transformer(x0 * x_mask, x_mask, generator=generator)
        return x0_ + x0

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, reverse: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.residual_connection:
            return super().forward(x, x_mask, g, reverse, generator)
        x0, x1 = torch.split(x, self.half_channels, dim=1)
        if not reverse:
            m, logs = self._stats(self.pre_transformer(
                x0, x_mask, generator=generator), x_mask)
            x1 = m + x1 * torch.exp(logs) * x_mask
            return x + torch.cat([x0, x1], dim=1)
        x0 = x0 / 2
        m, logs = self._stats(self.pre_transformer(
            x0, x_mask, generator=generator), x_mask)
        x1 = ((x1 - m) / (1 + torch.exp(-logs))) * x_mask
        return torch.cat([x0, x1], dim=1)


class ResidualCouplingBlock(nn.Module):
    """The flow stack. `transformer_flow_type=None` gives the VITS1 stack,
    n_flows x (coupling + flip); a transformer type puts its coupling in
    place of the VITS1 one (state_dict indices 2i), except the mono types,
    which keep it and add a mono layer after each flip, a period of 3
    modules (indices 3i and 3i + 2). `fft` reproduces the reference's
    argument swap (flows.py:381-389): its FFT gets n_layers=dilation_rate
    and n_heads=n_layers."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, n_flows: int = 4,
                 gin_channels: int = 0,
                 transformer_flow_type: Optional[str] = None):
        super().__init__()
        ftype = transformer_flow_type
        if ftype is not None and ftype not in AVAILABLE_FLOW_TYPES:
            raise ValueError(f"transformer_flow_type must be one of "
                             f"{AVAILABLE_FLOW_TYPES}, not {ftype!r}")
        args = (channels, hidden_channels, kernel_size, dilation_rate,
                n_layers)
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            if ftype == "pre_conv":
                coupling = ResidualCouplingTransformersLayer(
                    *args, gin_channels=gin_channels)
            elif ftype == "pre_conv2":
                coupling = ResidualCouplingTransformersLayer2(
                    *args, gin_channels=gin_channels)
            elif ftype == "fft":
                coupling = FFTransformerCouplingLayer(
                    channels, hidden_channels, kernel_size,
                    n_layers=dilation_rate, n_heads=n_layers,
                    gin_channels=gin_channels)
            else:
                coupling = ResidualCouplingLayer(
                    *args, gin_channels=gin_channels)
            self.flows.append(coupling)
            self.flows.append(Flip())
            if ftype in ("mono_layer_inter_residual",
                         "mono_layer_post_residual"):
                self.flows.append(MonoTransformerFlowLayer(
                    channels,
                    residual_connection=ftype == "mono_layer_post_residual"))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, reverse: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        flows = reversed(self.flows) if reverse else self.flows
        for flow in flows:
            x = flow(x, x_mask, g=g, reverse=reverse, generator=generator)
        return x
