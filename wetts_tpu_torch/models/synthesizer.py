"""VITS synthesizer, inference side (port of wetts_tpu/models/synthesizer.py;
reference wetts/vits/model/models.py:14-377).

infer (:228-280): duration sampling -> generate_path -> flow reverse ->
decoder, with the noise_scale / length_scale / noise_scale_w semantics, split
at z into encode_infer and decode for streaming callers (:282-363). As in the
JAX package, inference runs at a static `max_frames` bound with masks, the
realized lengths are clipped to it, and callers trim to them.

The public functions keep the JAX package's layout: phone ids [B, T_text],
latents and masks [B, T, C], the speaker vector g [B, 1, gin], audio
[B, T * hop, 1]. Inside, modules run on [B, C, T]. Every noise draw takes an
explicit `torch.Generator`. The posterior encoder (training, voice
conversion) is a later slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.duration import (
    DurationPredictor,
    StochasticDurationPredictor,
)
from wetts_tpu_torch.models.encoders import TextEncoder
from wetts_tpu_torch.models.flows import ResidualCouplingBlock
from wetts_tpu_torch.models.hifigan import Generator
from wetts_tpu_torch.ops.masking import generate_path, sequence_mask


def _bct(x: torch.Tensor) -> torch.Tensor:
    """[B, T, C] <-> [B, C, T]."""
    return x.transpose(1, 2)


class Synthesizer(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        m = cfg.model
        if m.vocoder_type != "hifigan" or m.use_transformer_flows \
                or m.use_spk_conditioned_encoder:
            raise NotImplementedError(
                "the port runs VITS1 with the HiFi-GAN decoder so far "
                f"(vocoder_type={m.vocoder_type!r}, "
                f"use_transformer_flows={m.use_transformer_flows}, "
                f"use_spk_conditioned_encoder="
                f"{m.use_spk_conditioned_encoder})")
        self.n_speakers = cfg.num_speakers
        self.use_sdp = m.use_sdp
        self.hop = math.prod(m.upsample_rates)
        gin = m.gin_channels
        self.enc_p = TextEncoder(cfg.num_phones, m.inter_channels,
                                 m.hidden_channels, m.filter_channels,
                                 m.n_heads, m.n_layers, m.kernel_size)
        self.dec = Generator(m.inter_channels, m.resblock,
                             m.resblock_kernel_sizes,
                             m.resblock_dilation_sizes, m.upsample_rates,
                             m.upsample_initial_channel,
                             m.upsample_kernel_sizes, gin_channels=gin)
        self.flow = ResidualCouplingBlock(m.inter_channels, m.hidden_channels,
                                          5, 1, 4, gin_channels=gin)
        if m.use_sdp:
            self.dp = StochasticDurationPredictor(m.hidden_channels, 3, 4,
                                                  gin_channels=gin)
        else:
            self.dp = DurationPredictor(m.hidden_channels, 256, 3,
                                        gin_channels=gin)
        if self.n_speakers > 0:
            self.emb_g = nn.Embedding(self.n_speakers, gin)

    def _speaker(self, sid: Optional[torch.Tensor]
                 ) -> Optional[torch.Tensor]:
        """Speaker ids [B] -> g [B, 1, gin], or None."""
        if self.n_speakers > 0 and sid is not None:
            return self.emb_g(sid)[:, None, :]
        return None

    def encode_prior(self, x, x_lengths, sid=None, noise_scale=1.0,
                     length_scale=1.0, noise_scale_w=1.0,
                     max_frames: int = 1000,
                     generator: Optional[torch.Generator] = None):
        """Phone ids -> prior latent z_p, before the flow reverse.

        Returns (z_p [B, max_frames, C], y_lengths [B], y_mask
        [B, max_frames, 1], attn [B, T_text, max_frames], g).
        """
        g = self._speaker(sid)
        g_in = None if g is None else _bct(g)
        x_h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths)
        if self.use_sdp:
            logw = self.dp(x_h, x_mask, g=g_in, noise_scale=noise_scale_w,
                           generator=generator)
        else:
            logw = self.dp(x_h, x_mask, g=g_in)
        w = torch.exp(logw) * x_mask * length_scale
        w_ceil = torch.ceil(w)[:, 0]  # [B, T_text]
        y_lengths = torch.clamp(w_ceil.sum(dim=-1), 1, max_frames).long()
        y_mask = sequence_mask(y_lengths, max_frames)[:, :, None]
        path_mask = x_mask[:, 0, :, None] * y_mask[:, None, :, 0]
        attn = generate_path(w_ceil, path_mask)  # [B, T_text, T_spec]
        m_p_e = m_p @ attn  # [B, C, T_spec]
        logs_p_e = logs_p @ attn
        noise = torch.randn(m_p_e.shape, generator=generator,
                            device=m_p_e.device, dtype=m_p_e.dtype)
        z_p = m_p_e + noise * torch.exp(logs_p_e) * noise_scale
        return _bct(z_p), y_lengths, y_mask, attn, g

    def flow_reverse(self, z_p, y_mask, g=None):
        """Prior latent [B, T, C] -> posterior latent z (masked)."""
        mask = _bct(y_mask)
        z = self.flow(_bct(z_p), mask, g=None if g is None else _bct(g),
                      reverse=True)
        return _bct(z * mask)

    def encode_infer(self, x, x_lengths, sid=None, noise_scale=1.0,
                     length_scale=1.0, noise_scale_w=1.0,
                     max_frames: int = 1000,
                     generator: Optional[torch.Generator] = None):
        """Phone ids -> latent z (the streaming encoder half, :282-331).
        Returns (z [B, max_frames, C], y_lengths, y_mask, attn, g)."""
        z_p, y_lengths, y_mask, attn, g = self.encode_prior(
            x, x_lengths, sid, noise_scale, length_scale, noise_scale_w,
            max_frames, generator)
        return self.flow_reverse(z_p, y_mask, g), y_lengths, y_mask, attn, g

    def decode(self, z, g=None, sid=None):
        """Latent z [B, T, C] -> waveform [B, T * hop, 1] (:360-363)."""
        if g is None:
            g = self._speaker(sid)
        o = self.dec(_bct(z), g=None if g is None else _bct(g))
        return _bct(o)

    def infer(self, x, x_lengths, sid=None, noise_scale=1.0,
              length_scale=1.0, noise_scale_w=1.0, max_frames: int = 1000,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full synthesis: (audio [B, max_frames * hop, 1], y_lengths,
        attn)."""
        z, y_lengths, _, attn, g = self.encode_infer(
            x, x_lengths, sid, noise_scale, length_scale, noise_scale_w,
            max_frames, generator)
        return self.decode(z, g), y_lengths, attn
