"""VITS / VITS2 synthesizer (port of wetts_tpu/models/synthesizer.py;
reference wetts/vits/model/models.py:14-377).

forward (:161-226) is the training pass: text encoder -> posterior encoder
-> flow -> monotonic alignment search (no gradient, kernel K2 on the GPU;
VITS2's noise-scaled MAS first adds std(scores) * N(0, 1) * scale to the
scores) -> duration loss -> prior expansion -> random segment slice ->
decoder.
infer (:228-280): duration sampling -> generate_path -> flow reverse ->
decoder, with the noise_scale / length_scale / noise_scale_w semantics, split
at z into encode_infer and decode for streaming callers (:282-363). As in the
JAX package, inference runs at a static `max_frames` bound with masks, the
realized lengths are clipped to it, and callers trim to them.
voice_conversion (:369-376): posterior encoder with the source speaker ->
flow forward -> flow reverse with the target speaker -> decoder.

The VITS2 options of the config build what the JAX package builds: the
transformer flows (`use_transformer_flows`, `transformer_flow_type`), the
speaker-conditioned text encoder (`use_spk_conditioned_encoder`) and the
Vocos decoder (`vocoder_type="vocos"`), and train with noise-scaled MAS
(`use_noise_scaled_mas`). Inside a data-parallel step the MAS noise's std
and the duration loss's phone count are those of the global batch
(`parallel/mesh.py`), as the JAX step's over its sharded batch.

The public functions keep the JAX package's layout: phone ids [B, T_text],
latents and masks [B, T, C], the speaker vector g [B, 1, gin], audio
[B, T * hop, 1], spectrograms [B, T_spec, bins]. Inside, modules run on
[B, C, T]. Every noise draw takes an explicit `torch.Generator`.

`flow_reverse` and `decode` take a `precision` ("f32", "bf16" or "int8"), as
the JAX engine's `half` / `quantize` options do (serving/engine.py:190-237):
under either reduced precision the flow runs in bf16, on a bf16 copy of its
folded parameters (every float tensor, the transformer flows' attention and
LayerNorm ones too) kept by `layers.DerivedWeights`' rule, and the decoder
at that precision (`dec.precisions`: Vocos has f32 alone); `encode_prior`
stays f32, so the realized lengths are those of f32.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.duration import (
    DurationPredictor,
    StochasticDurationPredictor,
)
from wetts_tpu_torch.models.encoders import PosteriorEncoder, TextEncoder
from wetts_tpu_torch.models.flows import ResidualCouplingBlock
from wetts_tpu_torch.models.hifigan import Generator
from wetts_tpu_torch.models.layers import DerivedWeights
from wetts_tpu_torch.models.vocos import VocosGenerator
from wetts_tpu_torch.ops import random
from wetts_tpu_torch.ops.mas import maximum_path
from wetts_tpu_torch.parallel.mesh import global_std, global_sum
from wetts_tpu_torch.ops.masking import (
    generate_path,
    rand_slice_segments,
    sequence_mask,
)
from wetts_tpu_torch.utils.profiling import StageTimes


def _bct(x: torch.Tensor) -> torch.Tensor:
    """[B, T, C] <-> [B, C, T]."""
    return x.transpose(1, 2)


class Synthesizer(DerivedWeights):
    def __init__(self, cfg: Config):
        super().__init__()
        m = cfg.model
        if m.vocoder_type not in ("hifigan", "vocos"):
            raise ValueError(f"unknown vocoder_type {m.vocoder_type!r}")
        self.use_noise_scaled_mas = m.use_noise_scaled_mas
        self.n_speakers = cfg.num_speakers
        self.use_sdp = m.use_sdp
        # the JAX engine's hop (serving/engine.py:124); both published VITS2
        # configs give 256, the iSTFT hop
        self.hop = math.prod(m.upsample_rates)
        self.segment_size = cfg.train.segment_size // cfg.data.hop_length
        gin = m.gin_channels
        self.enc_p = TextEncoder(
            cfg.num_phones, m.inter_channels, m.hidden_channels,
            m.filter_channels, m.n_heads, m.n_layers, m.kernel_size,
            p_dropout=m.p_dropout,
            gin_channels=gin if m.use_spk_conditioned_encoder else 0)
        if m.vocoder_type == "vocos":
            istft = m.vocos_istft_config
            self.dec = VocosGenerator(
                m.inter_channels, m.vocos_channels, m.vocos_h_channels,
                m.vocos_out_channels, m.vocos_num_layers,
                istft.get("n_fft", 1024), istft.get("hop_length", 256),
                istft.get("win_length", 1024), gin_channels=gin)
        else:
            self.dec = Generator(m.inter_channels, m.resblock,
                                 m.resblock_kernel_sizes,
                                 m.resblock_dilation_sizes, m.upsample_rates,
                                 m.upsample_initial_channel,
                                 m.upsample_kernel_sizes, gin_channels=gin)
        self.enc_q = PosteriorEncoder(cfg.data.spec_channels,
                                      m.inter_channels, m.hidden_channels,
                                      5, 1, 16, gin_channels=gin)
        self.flow = ResidualCouplingBlock(
            m.inter_channels, m.hidden_channels, 5, 1, 4, gin_channels=gin,
            transformer_flow_type=(m.transformer_flow_type
                                   if m.use_transformer_flows else None))
        if m.use_sdp:
            self.dp = StochasticDurationPredictor(m.hidden_channels, 3, 4,
                                                  gin_channels=gin)
        else:
            self.dp = DurationPredictor(m.hidden_channels, 256, 3,
                                        gin_channels=gin)
        if self.n_speakers > 0:
            self.emb_g = nn.Embedding(self.n_speakers, gin)

    def flow_at(self, precision: str) -> ResidualCouplingBlock:
        """The flow `flow_reverse` runs at `precision`: its own at "f32",
        else a derived copy with the folded parameters cast to bf16."""
        if precision == "f32":
            return self.flow
        if self.training:
            raise RuntimeError("the bf16 flow is an inference route: call "
                               "eval() first")
        return self.derived(
            "flow_bf16",
            lambda: [(m, name) for m in self.flow.modules()
                     for name, t in (*m._parameters.items(),
                                     *m._buffers.items()) if t is not None],
            lambda: copy.deepcopy(self.flow).to(torch.bfloat16).eval())

    def prepare(self, precision: str) -> None:
        """Derive what inference at `precision` reads now, not at the first
        call; a decoder without that precision raises ValueError."""
        self.dec.prepare(precision)
        self.flow_at(precision)

    def _speaker(self, sid: Optional[torch.Tensor]
                 ) -> Optional[torch.Tensor]:
        """Speaker ids [B] -> g [B, 1, gin], or None."""
        if self.n_speakers > 0 and sid is not None:
            return self.emb_g(sid)[:, None, :]
        return None

    def forward(self, x, x_lengths, y, y_lengths, sid=None,
                generator: Optional[torch.Generator] = None,
                mas_noise_scale: float = 0.0) -> Dict[str, Any]:
        """Training forward.

        x: [B, T_text] phone ids; y: [B, T_spec, spec_channels]. Returns the
        decoder slice, the duration loss, the alignment, masks and flow
        statistics under the JAX package's keys and layouts.
        mas_noise_scale: the noise-scaled MAS's scale (a model built with
        `use_noise_scaled_mas` draws the noise at any scale, 0 included,
        as the JAX package does; another ignores it).
        """
        g = self._speaker(sid)
        g_in = None if g is None else _bct(g)
        x_h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths, generator,
                                              g=g_in)
        z, m_q, logs_q, y_mask = self.enc_q(_bct(y), y_lengths, g=g_in,
                                            generator=generator)
        z_p = self.flow(z, y_mask, g=g_in, generator=generator)

        # MAS, no gradients (reference :171-194); [B, T_spec, T_text]. The
        # scores are f32 under autocast too, as the JAX bf16 step's
        # (preferred_element_type=f32): K2 takes them as they are
        with torch.no_grad(), torch.autocast(z_p.device.type, enabled=False):
            z_p_, m_p_, logs_p_ = z_p.float(), m_p.float(), logs_p.float()
            s_p_sq_r = torch.exp(-2.0 * logs_p_)  # [B, C, T_text]
            zp_t = _bct(z_p_)  # [B, T_spec, C]
            neg_cent1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p_,
                                  dim=1)[:, None, :]
            neg_cent2 = torch.matmul(-0.5 * zp_t ** 2, s_p_sq_r)
            neg_cent3 = torch.matmul(zp_t, m_p_ * s_p_sq_r)
            neg_cent4 = torch.sum(-0.5 * m_p_ ** 2 * s_p_sq_r,
                                  dim=1)[:, None, :]
            neg_cent = neg_cent1 + neg_cent2 + neg_cent3 + neg_cent4
            if self.use_noise_scaled_mas:
                # the population std over every cell, padding included; the
                # draw [B, T_text, T_spec] is channel-first, as every draw
                # of the port
                noise = random.normal(
                    (neg_cent.shape[0], neg_cent.shape[2], neg_cent.shape[1]),
                    neg_cent.device, neg_cent.dtype, generator)
                neg_cent = neg_cent + (global_std(neg_cent)
                                       * _bct(noise) * mas_noise_scale)
            attn_mask = _bct(y_mask) * x_mask  # [B, T_spec, T_text]
            attn = maximum_path(neg_cent, attn_mask)

        w = attn.sum(dim=1)[:, None, :]  # [B, 1, T_text]
        logw_ = torch.log(w + 1e-6) * x_mask
        # the phones of the whole batch (of the global batch inside a
        # data-parallel step, as the std above)
        n_text = global_sum(torch.sum(x_mask))
        if self.use_sdp:
            l_length = self.dp.nll(x_h, x_mask, w, g=g_in,
                                   generator=generator) / n_text
            logw = self.dp(x_h, x_mask, g=g_in, noise_scale=1.0,
                           generator=generator)
        else:
            logw = self.dp(x_h, x_mask, g=g_in, generator=generator)
            l_length = torch.sum((logw - logw_) ** 2,
                                 dim=(1, 2)) / n_text

        # expand the prior over spec frames (reference :209-212)
        m_p_e = torch.matmul(attn, _bct(m_p))  # [B, T_spec, C]
        logs_p_e = torch.matmul(attn, _bct(logs_p))

        z_t = _bct(z)
        z_slice, ids_slice = rand_slice_segments(
            z_t, y_lengths, self.segment_size, generator)
        o = self.dec(_bct(z_slice), g=g_in)
        return {
            "audio": _bct(o),
            "l_length": l_length,
            "attn": attn,
            "ids_slice": ids_slice,
            "x_mask": _bct(x_mask),
            "y_mask": _bct(y_mask),
            "z": z_t, "z_p": _bct(z_p), "m_p": m_p_e,
            "logs_p": logs_p_e,
            "m_q": _bct(m_q), "logs_q": _bct(logs_q),
            "x_hidden": _bct(x_h), "logw": _bct(logw), "logw_": _bct(logw_),
            "g": g,
        }

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
        x_h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths, g=g_in)
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
        noise = random.normal(m_p_e.shape, m_p_e.device, m_p_e.dtype,
                              generator)
        z_p = m_p_e + noise * torch.exp(logs_p_e) * noise_scale
        return _bct(z_p), y_lengths, y_mask, attn, g

    def flow_reverse(self, z_p, y_mask, g=None, precision: str = "f32"):
        """Prior latent [B, T, C] -> posterior latent z (masked); in bf16
        (inputs cast, z returned in bf16) unless `precision` is "f32"."""
        flow = self.flow_at(precision)
        if precision != "f32":
            z_p, y_mask = z_p.to(torch.bfloat16), y_mask.to(torch.bfloat16)
            g = None if g is None else g.to(torch.bfloat16)
        mask = _bct(y_mask)
        z = flow(_bct(z_p), mask, g=None if g is None else _bct(g),
                 reverse=True)
        return _bct(z * mask)

    def encode_infer(self, x, x_lengths, sid=None, noise_scale=1.0,
                     length_scale=1.0, noise_scale_w=1.0,
                     max_frames: int = 1000,
                     generator: Optional[torch.Generator] = None,
                     precision: str = "f32"):
        """Phone ids -> latent z (the streaming encoder half, :282-331).
        Returns (z [B, max_frames, C], y_lengths, y_mask, attn, g)."""
        z_p, y_lengths, y_mask, attn, g = self.encode_prior(
            x, x_lengths, sid, noise_scale, length_scale, noise_scale_w,
            max_frames, generator)
        return (self.flow_reverse(z_p, y_mask, g, precision), y_lengths,
                y_mask, attn, g)

    def decode(self, z, g=None, sid=None, precision: str = "f32",
               stages: Optional[StageTimes] = None):
        """Latent z [B, T, C] -> waveform [B, T * hop, 1] in f32
        (:360-363), the decoder at `precision`. Given `stages`, the decoder
        times its own stages into it (the Vocos decoder its backbone and
        iSTFT; HiFi-GAN's decode has none)."""
        if g is None:
            g = self._speaker(sid)
        o = self.dec(_bct(z), g=None if g is None else _bct(g),
                     precision=precision, stages=stages)
        return _bct(o)

    def infer(self, x, x_lengths, sid=None, noise_scale=1.0,
              length_scale=1.0, noise_scale_w=1.0, max_frames: int = 1000,
              generator: Optional[torch.Generator] = None,
              precision: str = "f32"
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full synthesis: (audio [B, max_frames * hop, 1], y_lengths,
        attn), the flow reverse and the decoder at `precision`."""
        z, y_lengths, _, attn, g = self.encode_infer(
            x, x_lengths, sid, noise_scale, length_scale, noise_scale_w,
            max_frames, generator, precision)
        return self.decode(z, g, precision=precision), y_lengths, attn

    def voice_conversion(self, y, y_lengths, sid_src, sid_tgt,
                         generator: Optional[torch.Generator] = None):
        """Re-speak y as another speaker (:369-376): the posterior encoder
        and the flow forward with the source speaker's g, the flow reverse
        and the decoder with the target's, in f32.

        y: [B, T_spec, spec_channels] (the linear spectrogram, or the
        log-mel under use_mel_posterior_encoder). Returns (audio
        [B, T_spec * hop, 1], y_mask [B, T_spec, 1], (z, z_p, z_hat), each
        [B, T_spec, C])."""
        g_src, g_tgt = (None if g is None else _bct(g) for g in (
            self._speaker(sid_src), self._speaker(sid_tgt)))
        z, _, _, y_mask = self.enc_q(_bct(y), y_lengths, g=g_src,
                                     generator=generator)
        z_p = self.flow(z, y_mask, g=g_src)
        z_hat = self.flow(z_p, y_mask, g=g_tgt, reverse=True)
        o_hat = self.dec(z_hat * y_mask, g=g_tgt)
        return _bct(o_hat), _bct(y_mask), (_bct(z), _bct(z_p), _bct(z_hat))
