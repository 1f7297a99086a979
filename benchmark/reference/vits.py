"""VITS inference in plain PyTorch: the benchmark's reference for both
configurations (reference wetts/vits/model/models.py:228-363, with
encoders.py, flows.py, duration_predictors.py and decoders.py).

The text encoder, the stochastic duration predictor run in reverse, the
prior expansion with its noise, the coupling flows in reverse (the VITS1 WN
coupling, or VITS2's `pre_conv` transformer coupling) and the decoder
(HiFi-GAN with its MRF stages as eager convolutions, or Vocos with its
inverse STFT). Nothing here calls a hand-written kernel: every convolution
is `F.conv1d`. Draws take the caller's generator in the order and shapes the
published model draws them: the duration noise [B, 2, T_text], then the
prior noise [B, C, T_frames].
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import (
    LRELU_SLOPE,
    Conv1d,
    ConvTranspose1d,
    Encoder,
    LayerNorm,
    gated,
    get_padding,
)
from benchmark.reference.splines import piecewise_rational_quadratic_transform


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    pos = torch.arange(max_length, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).float()


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Integer durations [B, T_text] -> monotonic path [B, T_text, T_spec]."""
    cum = torch.cumsum(duration, dim=-1)
    pos = torch.arange(mask.shape[-1], device=duration.device,
                       dtype=cum.dtype)
    path = (pos[None, None, :] < cum[:, :, None]).float()
    path = path - F.pad(path, (0, 0, 1, 0))[:, :-1]
    return path * mask


class WN(nn.Module):
    def __init__(self, hidden: int, kernel_size: int, n_layers: int,
                 gin_channels: int):
        super().__init__()
        self.hidden, self.n_layers = hidden, n_layers
        self.cond_layer = Conv1d(gin_channels, 2 * hidden * n_layers, 1,
                                 weight_norm=True)
        self.in_layers = nn.ModuleList(
            Conv1d(hidden, 2 * hidden, kernel_size,
                   padding=get_padding(kernel_size), weight_norm=True)
            for _ in range(n_layers))
        self.res_skip_layers = nn.ModuleList(
            Conv1d(hidden, 2 * hidden if i < n_layers - 1 else hidden, 1,
                   weight_norm=True) for i in range(n_layers))

    def forward(self, x, x_mask, g):
        h = self.hidden
        output = torch.zeros_like(x)
        g_all = self.cond_layer(g)
        for i, (inl, rsl) in enumerate(zip(self.in_layers,
                                           self.res_skip_layers)):
            rs = rsl(gated(inl(x), g_all[:, 2 * h * i: 2 * h * (i + 1)], h))
            if i < self.n_layers - 1:
                x = (x + rs[:, :h]) * x_mask
                output = output + rs[:, h:]
            else:
                output = output + rs
        return output * x_mask


class Coupling(nn.Module):
    """Mean-only affine coupling: pre -> WN -> post on x0, with VITS2's
    `pre_conv` transformer (2 layers, 2 heads, no window) on x0 first."""

    def __init__(self, channels: int, hidden: int, gin_channels: int,
                 pre_conv: bool):
        super().__init__()
        self.half = channels // 2
        if pre_conv:
            self.pre_transformer = Encoder(self.half, self.half, 2, 2, 3,
                                           window_size=None)
        self.pre = Conv1d(self.half, hidden, 1)
        self.enc = WN(hidden, 5, 4, gin_channels)
        self.post = Conv1d(hidden, self.half, 1)

    def reverse(self, x, x_mask, g):
        x0, x1 = torch.split(x, self.half, dim=1)
        h = x0
        if hasattr(self, "pre_transformer"):
            h = self.pre_transformer(x0 * x_mask, x_mask) + x0
        h = self.enc(self.pre(h) * x_mask, x_mask, g)
        m = self.post(h) * x_mask
        return torch.cat([x0, (x1 - m) * x_mask], dim=1)


class Flow(nn.Module):
    """Four couplings, each followed by a flip (state-dict indices 2i)."""

    def __init__(self, channels: int, hidden: int, gin_channels: int,
                 flow_type: Optional[str]):
        super().__init__()
        if flow_type not in (None, "pre_conv"):
            raise ValueError(f"the reference has no {flow_type!r} flow")
        self.flows = nn.ModuleList()
        for _ in range(4):
            self.flows.append(Coupling(channels, hidden, gin_channels,
                                       flow_type == "pre_conv"))
            self.flows.append(nn.Identity())  # the flip, no parameters

    def reverse(self, x, x_mask, g):
        for i in range(len(self.flows) - 2, -1, -2):
            x = self.flows[i].reverse(torch.flip(x, dims=[1]), x_mask, g)
        return x


class DDSConv(nn.Module):
    def __init__(self, channels: int, kernel_size: int, n_layers: int):
        super().__init__()
        self.convs_sep = nn.ModuleList()
        self.convs_1x1 = nn.ModuleList()
        self.norms_1 = nn.ModuleList()
        self.norms_2 = nn.ModuleList()
        for i in range(n_layers):
            d = kernel_size ** i
            self.convs_sep.append(Conv1d(
                channels, channels, kernel_size,
                padding=(kernel_size * d - d) // 2, dilation=d,
                groups=channels))
            self.convs_1x1.append(Conv1d(channels, channels, 1))
            self.norms_1.append(LayerNorm(channels))
            self.norms_2.append(LayerNorm(channels))

    def forward(self, x, x_mask, g=None):
        if g is not None:
            x = x + g
        for sep, pw, n1, n2 in zip(self.convs_sep, self.convs_1x1,
                                   self.norms_1, self.norms_2):
            y = F.gelu(n1(sep(x * x_mask)))
            x = x + F.gelu(n2(pw(y)))
        return x * x_mask


class ConvFlow(nn.Module):
    def __init__(self, filter_channels: int, kernel_size: int,
                 num_bins: int = 10, tail_bound: float = 5.0):
        super().__init__()
        self.filter_channels = filter_channels
        self.num_bins, self.tail_bound = num_bins, tail_bound
        self.pre = Conv1d(1, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, 3)
        self.proj = Conv1d(filter_channels, num_bins * 3 - 1, 1)

    def reverse(self, x, x_mask, g):
        x0, x1 = torch.split(x, 1, dim=1)
        h = self.proj(self.convs(self.pre(x0), x_mask, g=g)) * x_mask
        b, _, t = x0.shape
        h = h.reshape(b, 1, -1, t).permute(0, 1, 3, 2)
        denom = math.sqrt(self.filter_channels)
        k = self.num_bins
        x1, _ = piecewise_rational_quadratic_transform(
            x1, h[..., :k] / denom, h[..., k: 2 * k] / denom, h[..., 2 * k:],
            inverse=True, tails="linear", tail_bound=self.tail_bound)
        return torch.cat([x0, x1], dim=1) * x_mask


class ElementwiseAffine(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def reverse(self, x, x_mask, g):
        return (x - self.m) * torch.exp(-self.logs) * x_mask


class StochasticDurationPredictor(nn.Module):
    """The reverse direction only: noise [B, 2, T] through the reversed flow
    chain without its first ConvFlow (duration_predictors.py:254-263). The
    posterior flows that only training reads are not built."""

    def __init__(self, channels: int, kernel_size: int, gin_channels: int):
        super().__init__()
        self.flows = nn.ModuleList([ElementwiseAffine(2)])
        for _ in range(4):
            self.flows.extend([ConvFlow(channels, kernel_size),
                               nn.Identity()])
        self.pre = Conv1d(channels, channels, 1)
        self.proj = Conv1d(channels, channels, 1)
        self.convs = DDSConv(channels, kernel_size, 3)
        self.cond = Conv1d(gin_channels, channels, 1)

    def forward(self, x, x_mask, g, noise_scale, generator):
        x = self.pre(x) + self.cond(g)
        x = self.proj(self.convs(x, x_mask)) * x_mask
        z = torch.randn((x.shape[0], 2, x.shape[2]), generator=generator,
                        device=x.device, dtype=x.dtype) * noise_scale
        # reversed: flip, ConvFlow 7, flip, ConvFlow 5, flip, ConvFlow 3,
        # flip (ConvFlow 1 left out), ElementwiseAffine 0
        for i in (8, 7, 6, 5, 4, 3, 2, 0):
            module = self.flows[i]
            if isinstance(module, nn.Identity):
                z = torch.flip(z, dims=[1])
            else:
                z = module.reverse(z, x_mask, x)
        return z[:, :1]


class TextEncoder(nn.Module):
    def __init__(self, n_vocab: int, out_channels: int, hidden: int,
                 filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int):
        super().__init__()
        self.out_channels, self.hidden = out_channels, hidden
        self.emb = nn.Embedding(n_vocab, hidden)
        self.encoder = Encoder(hidden, filter_channels, n_heads, n_layers,
                               kernel_size)
        self.proj = Conv1d(hidden, out_channels * 2, 1)

    def forward(self, x, x_lengths):
        h = self.emb(x) * math.sqrt(self.hidden)
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, None, :]
        h = self.encoder(h.transpose(1, 2) * x_mask, x_mask)
        stats = self.proj(h) * x_mask
        m, logs = torch.split(stats, self.out_channels, dim=1)
        return h, m, logs, x_mask


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilations):
        super().__init__()
        self.kernel_size, self.dilations = kernel_size, tuple(dilations)
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=get_padding(kernel_size, d), weight_norm=True)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size,
                   padding=get_padding(kernel_size), weight_norm=True)
            for _ in dilations)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)),
                                LRELU_SLOPE)) + x
        return x


class HiFiGAN(nn.Module):
    """conv_pre (+ cond) -> per stage: leaky_relu -> transposed conv -> the
    mean of the resblock branches -> leaky_relu(0.01) -> conv_post -> tanh."""

    def __init__(self, m: dict):
        super().__init__()
        if m["resblock"] != "1":
            raise ValueError("the reference builds ResBlock1 decoders only")
        ch = m["upsample_initial_channel"]
        self.conv_pre = Conv1d(m["inter_channels"], ch, 7, padding=3)
        self.cond = Conv1d(m["gin_channels"], ch, 1)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        self.n_branches = len(m["resblock_kernel_sizes"])
        for u, k in zip(m["upsample_rates"], m["upsample_kernel_sizes"]):
            self.ups.append(ConvTranspose1d(ch, ch // 2, k, u,
                                            padding=(k - u) // 2,
                                            weight_norm=True))
            ch //= 2
            for rk, rd in zip(m["resblock_kernel_sizes"],
                              m["resblock_dilation_sizes"]):
                self.resblocks.append(ResBlock1(ch, rk, rd))
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)

    def forward(self, x, g):
        x = self.conv_pre(x) + self.cond(g)
        n = self.n_branches
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            xs = None
            for rb in self.resblocks[i * n:(i + 1) * n]:
                y = rb(x)
                xs = y if xs is None else xs + y
            x = xs / n
        return torch.tanh(self.conv_post(F.leaky_relu(x, 0.01)))


class ConvNeXtLayer(nn.Module):
    def __init__(self, channels: int, h_channels: int):
        super().__init__()
        self.dw_conv = Conv1d(channels, channels, 3, padding=1,
                              groups=channels)
        self.norm = LayerNorm(channels)
        self.pw_conv1 = Conv1d(channels, h_channels, 1)
        self.pw_conv2 = Conv1d(h_channels, channels, 1)
        self.scale = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        h = self.pw_conv2(F.gelu(self.pw_conv1(self.norm(self.dw_conv(x)))))
        return x + self.scale[:, None] * h


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop: int,
          win: int) -> torch.Tensor:
    """Inverse STFT, center=True, periodic Hann window: [B, F, bins] real
    and imaginary parts -> [B, (F - 1) * hop]. The DC and Nyquist bins'
    imaginary parts are dropped, as a real inverse FFT reads them."""
    imag = imag.clone()
    imag[..., 0] = 0.0
    imag[..., -1] = 0.0
    n = torch.arange(win, device=real.device, dtype=torch.float64)
    window = (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win)).float()
    spec = torch.complex(real, imag).transpose(1, 2)
    return torch.istft(spec, n_fft, hop_length=hop, win_length=win,
                       window=window, center=True)


class Vocos(nn.Module):
    """Reflection pad of one frame -> in_conv (+ cond) -> LayerNorm ->
    ConvNeXt layers -> LayerNorm -> out_conv to log-magnitude and phase ->
    exp clamped at 1e2 -> inverse STFT."""

    def __init__(self, m: dict):
        super().__init__()
        c = m["vocos_channels"]
        ist = m["vocos_istft_config"]
        self.istft_args = (ist["n_fft"], ist["hop_length"],
                           ist["win_length"])
        self.in_conv = Conv1d(m["inter_channels"], c, 1)
        self.cond = Conv1d(m["gin_channels"], c, 1)
        self.norm_pre = LayerNorm(c)
        self.layers = nn.ModuleList(
            ConvNeXtLayer(c, m["vocos_h_channels"])
            for _ in range(m["vocos_num_layers"]))
        self.norm_post = LayerNorm(c)
        self.out_conv = Conv1d(c, m["vocos_out_channels"], 1)

    def forward(self, x, g):
        x = self.in_conv(F.pad(x, (1, 0), mode="reflect")) + self.cond(g)
        x = self.norm_pre(x)
        for layer in self.layers:
            x = layer(x)
        x = self.out_conv(self.norm_post(x))
        log_mag, phase = torch.chunk(x, 2, dim=1)
        mag = torch.clamp(torch.exp(log_mag), max=1e2)
        audio = istft((mag * torch.cos(phase)).transpose(1, 2),
                      (mag * torch.sin(phase)).transpose(1, 2),
                      *self.istft_args)
        return audio[:, None, :]


class Synthesizer(nn.Module):
    """The inference half of SynthesizerTrn, for the configuration dict
    `cfg` (the benchmark's configuration file): `encode_prior`,
    `flow_reverse`, `decode`. Layouts: phone ids [B, T_text]; latents
    [B, C, T]; g [B, gin, 1]."""

    def __init__(self, cfg: dict):
        super().__init__()
        m = cfg["model"]
        gin = m["gin_channels"]
        self.hop = math.prod(m["upsample_rates"])
        self.enc_p = TextEncoder(
            cfg["num_phones"], m["inter_channels"], m["hidden_channels"],
            m["filter_channels"], m["n_heads"], m["n_layers"],
            m["kernel_size"])
        vocos = m.get("vocoder_type", "hifigan") == "vocos"
        self.dec = Vocos(m) if vocos else HiFiGAN(m)
        self.flow = Flow(m["inter_channels"], m["hidden_channels"], gin,
                         m.get("transformer_flow_type")
                         if m.get("use_transformer_flows") else None)
        if not m.get("use_sdp", True):
            raise ValueError("the reference builds the stochastic duration "
                             "predictor only")
        self.dp = StochasticDurationPredictor(m["hidden_channels"], 3, gin)
        self.emb_g = nn.Embedding(cfg["num_speakers"], gin)

    def speaker(self, sid: torch.Tensor) -> torch.Tensor:
        return self.emb_g(sid)[:, :, None]

    def encode_prior(self, x, x_lengths, g, noise_scale, length_scale,
                     noise_scale_w, max_frames, generator):
        """-> (z_p [B, C, max_frames], y_lengths [B], y_mask
        [B, 1, max_frames])."""
        x_h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths)
        logw = self.dp(x_h, x_mask, g, noise_scale_w, generator)
        w_ceil = torch.ceil(torch.exp(logw) * x_mask * length_scale)[:, 0]
        y_lengths = torch.clamp(w_ceil.sum(dim=-1), 1, max_frames).long()
        y_mask = sequence_mask(y_lengths, max_frames)[:, None, :]
        attn = generate_path(w_ceil, x_mask[:, 0, :, None] * y_mask)
        m_p_e, logs_p_e = m_p @ attn, logs_p @ attn
        noise = torch.randn(m_p_e.shape, generator=generator,
                            device=m_p_e.device, dtype=m_p_e.dtype)
        z_p = m_p_e + noise * torch.exp(logs_p_e) * noise_scale
        return z_p, y_lengths, y_mask

    def flow_reverse(self, z_p, y_mask, g):
        return self.flow.reverse(z_p, y_mask, g) * y_mask

    def decode(self, z, g):
        """z [B, C, T] -> audio [B, T * hop]."""
        return self.dec(z, g)[:, 0]
