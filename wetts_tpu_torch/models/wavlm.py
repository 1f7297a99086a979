"""WavLM speech encoder, the frozen feature extractor of the SLM loss (port
of wetts_tpu/models/wavlm.py; the role microsoft/wavlm-base-plus plays in
the reference's WavLMLoss, wetts/vits/losses.py:63-153).

The base variant: a group-norm conv feature encoder, a post-norm
transformer encoder, gated relative-position-bias attention with T5-style
log buckets, exact-erf GELU. Parameters keep HuggingFace's `WavLMModel`
state-dict names (without the `wavlm.` prefix of a model with a head), so
a HF `pytorch_model.bin` loads with one `load_state_dict`. The positional
conv is weight-normed over dim 2, one norm per kernel tap over [O, I/g]
(`weight_g` [1, 1, K], `weight_v` [O, I/g, K]); both HF spellings load,
`weight_g`/`weight_v` and `parametrizations.weight.original0/1`.
`masked_spec_embed`, HF's mask embedding, is kept so that its files load,
and is not used: nothing is masked here.

Attention is plain tensor code, as the JAX module's is (no kernel there).
Waveforms are [B, T]; hidden states [B, T', H].
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wetts_tpu_torch.ops.resample import resample


@dataclass(frozen=True)
class WavLMConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_distance: int = 800
    layer_norm_eps: float = 1e-5

    @classmethod
    def tiny(cls) -> "WavLMConfig":
        return cls(hidden_size=32, num_layers=2, num_heads=4,
                   intermediate_size=64, conv_dim=(16, 16, 16),
                   conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
                   num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4, num_buckets=40,
                   max_distance=100)

    @classmethod
    def from_hf(cls, hf: dict) -> "WavLMConfig":
        """From a HF `config.json` as a dict."""
        return cls(
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            conv_dim=tuple(hf["conv_dim"]),
            conv_kernel=tuple(hf["conv_kernel"]),
            conv_stride=tuple(hf["conv_stride"]),
            conv_bias=hf.get("conv_bias", False),
            num_conv_pos_embeddings=hf["num_conv_pos_embeddings"],
            num_conv_pos_embedding_groups=hf[
                "num_conv_pos_embedding_groups"],
            num_buckets=hf.get("num_buckets", 320),
            max_distance=hf.get("max_bucket_distance", 800),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-5))

    def to_hf(self) -> dict:
        """The keys of a HF `config.json` that `from_hf` reads."""
        return {"hidden_size": self.hidden_size,
                "num_hidden_layers": self.num_layers,
                "num_attention_heads": self.num_heads,
                "intermediate_size": self.intermediate_size,
                "conv_dim": list(self.conv_dim),
                "conv_kernel": list(self.conv_kernel),
                "conv_stride": list(self.conv_stride),
                "conv_bias": self.conv_bias,
                "num_conv_pos_embeddings": self.num_conv_pos_embeddings,
                "num_conv_pos_embedding_groups":
                    self.num_conv_pos_embedding_groups,
                "num_buckets": self.num_buckets,
                "max_bucket_distance": self.max_distance,
                "layer_norm_eps": self.layer_norm_eps}


class _ConvLayer(nn.Module):
    """One conv of the feature encoder; GroupNorm (one group per channel)
    on the first only, then GELU."""

    def __init__(self, c: WavLMConfig, i: int):
        super().__init__()
        c_in = 1 if i == 0 else c.conv_dim[i - 1]
        self.conv = nn.Conv1d(c_in, c.conv_dim[i], c.conv_kernel[i],
                              stride=c.conv_stride[i], bias=c.conv_bias)
        if i == 0:
            self.layer_norm = nn.GroupNorm(c.conv_dim[i], c.conv_dim[i],
                                           eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if hasattr(self, "layer_norm"):
            x = self.layer_norm(x)
        return F.gelu(x)


class FeatureEncoder(nn.Module):
    """Waveform [B, T] -> conv features [B, C, T']."""

    def __init__(self, c: WavLMConfig):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            [_ConvLayer(c, i) for i in range(len(c.conv_dim))])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None, :]
        for layer in self.conv_layers:
            h = layer(h)
        return h


class FeatureProjection(nn.Module):
    def __init__(self, c: WavLMConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c.conv_dim[-1], eps=c.layer_norm_eps)
        self.projection = nn.Linear(c.conv_dim[-1], c.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


_HF_WEIGHT_NORM = (("weight_g", "parametrizations.weight.original0"),
                   ("weight_v", "parametrizations.weight.original1"))


class PositionalConv(nn.Module):
    """The grouped positional conv, weight-normed over dim 2: kernel =
    v * g / ||v||, the norm per tap k over [O, I/g]."""

    def __init__(self, c: WavLMConfig):
        super().__init__()
        k, h = c.num_conv_pos_embeddings, c.hidden_size
        self.groups = c.num_conv_pos_embedding_groups
        self.weight_g = nn.Parameter(torch.ones(1, 1, k))
        self.weight_v = nn.Parameter(torch.zeros(h, h // self.groups, k))
        self.bias = nn.Parameter(torch.zeros(h))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for ours, theirs in _HF_WEIGHT_NORM:
            if prefix + theirs in state_dict:
                state_dict[prefix + ours] = state_dict.pop(prefix + theirs)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.weight_v
        norm = torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True))
        kernel = v * (self.weight_g / torch.clamp_min(norm, 1e-12))
        k = v.shape[-1]
        y = F.conv1d(x, kernel, self.bias, padding=k // 2,
                     groups=self.groups)
        if k % 2 == 0:  # SAME-padded with an even kernel: one frame over
            y = y[:, :, :-1]
        return F.gelu(y)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, c: WavLMConfig):
        super().__init__()
        self.conv = PositionalConv(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def relative_bucket(rel: torch.Tensor, num_buckets: int,
                    max_distance: int) -> torch.Tensor:
    """T5-style buckets of relative positions (key - query): exact up to
    num_buckets / 4, logarithmic beyond, one half per sign."""
    nb = num_buckets // 2
    buckets = (rel > 0).long() * nb
    rel = rel.abs()
    max_exact = nb // 2
    large = (max_exact + torch.log(rel.clamp_min(1).float() / max_exact)
             / math.log(max_distance / max_exact)
             * (nb - max_exact)).long()
    large = torch.clamp_max(large, nb - 1)
    return buckets + torch.where(rel < max_exact, rel, large)


class WavLMAttention(nn.Module):
    """Multi-head self-attention with the gated relative position bias. The
    first layer owns the bucket embedding; later layers take its bias."""

    def __init__(self, c: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        self.cfg = c
        h, self.num_heads = c.hidden_size, c.num_heads
        self.head_dim = h // c.num_heads
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.q_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)
        self.gru_rel_pos_linear = nn.Linear(self.head_dim, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, c.num_heads, 1,
                                                         1))
        if has_relative_position_bias:
            self.rel_attn_embed = nn.Embedding(c.num_buckets, c.num_heads)

    def position_bias(self, t: int, device) -> torch.Tensor:
        """[H, T, T] from the bucket embedding."""
        pos = torch.arange(t, device=device)
        buckets = relative_bucket(pos[None, :] - pos[:, None],
                                  self.cfg.num_buckets,
                                  self.cfg.max_distance)
        return self.rel_attn_embed(buckets).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, position_bias: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t, _ = x.shape
        if position_bias is None:
            position_bias = self.position_bias(t, x.device)

        def heads(a):  # [B, T, H * D] -> [B, H, T, D]
            return a.reshape(b, t, self.num_heads, self.head_dim
                             ).transpose(1, 2)

        proj = self.gru_rel_pos_linear(heads(x))  # [B, H, T, 8]
        proj = proj.reshape(b, self.num_heads, t, 2, 4).sum(-1)
        gate_a, gate_b = torch.sigmoid(proj).unbind(-1)  # [B, H, T]
        gate = gate_a * (gate_b * self.gru_rel_pos_const[..., 0] - 1.0) + 2.0
        bias = gate[..., None] * position_bias[None]  # [B, H, T, T]

        scores = heads(self.q_proj(x)) @ heads(self.k_proj(x)).transpose(
            -1, -2)
        probs = torch.softmax(scores / math.sqrt(self.head_dim) + bias, -1)
        out = (probs @ heads(self.v_proj(x))).transpose(1, 2).reshape(
            b, t, -1)
        return self.out_proj(out), position_bias


class FeedForward(nn.Module):
    def __init__(self, c: WavLMConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(c.hidden_size,
                                            c.intermediate_size)
        self.output_dense = nn.Linear(c.intermediate_size, c.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class WavLMEncoderLayer(nn.Module):
    """Post-norm: x + attention, LayerNorm, x + feed-forward, LayerNorm."""

    def __init__(self, c: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        self.attention = WavLMAttention(c, has_relative_position_bias)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.feed_forward = FeedForward(c)
        self.final_layer_norm = nn.LayerNorm(c.hidden_size,
                                             eps=c.layer_norm_eps)

    def forward(self, x, position_bias):
        attn, position_bias = self.attention(x, position_bias)
        x = self.layer_norm(x + attn)
        x = self.final_layer_norm(x + self.feed_forward(x))
        return x, position_bias


class WavLMEncoder(nn.Module):
    def __init__(self, c: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(c)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.layers = nn.ModuleList([WavLMEncoderLayer(c, i == 0)
                                     for i in range(c.num_layers)])

    def forward(self, h: torch.Tensor) -> List[torch.Tensor]:
        pos = self.pos_conv_embed(h.transpose(1, 2)).transpose(1, 2)
        h = self.layer_norm(h + pos)
        hidden_states = [h]
        position_bias = None
        for layer in self.layers:
            h, position_bias = layer(h, position_bias)
            hidden_states.append(h)
        return hidden_states


class WavLMModel(nn.Module):
    """Waveform [B, T] -> hidden states, num_layers + 1 tensors [B, T', H]
    (the encoder's input after its LayerNorm, then each layer's output)."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.cfg = cfg
        self.masked_spec_embed = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.feature_extractor = FeatureEncoder(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = WavLMEncoder(cfg)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feat = self.feature_extractor(x).transpose(1, 2)
        return self.encoder(self.feature_projection(feat))


def make_slm_feature_fn(model: WavLMModel, model_sr: int,
                        slm_sr: int = 16000
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """wav [B, T, 1] or [B, T] at `model_sr` -> stacked hidden features
    [B, T', H * (L + 1)], layer-major over channels (index l * H + h), as
    the reference stacks them (torch.stack(hidden_states, 1)
    .transpose(-1, -2).flatten(1, 2), losses.py:95-99) but channel-last.

    The model is frozen here (no parameter requires grad, eval mode); the
    features stay differentiable in the waveform. They are computed in f32
    with autocast off, resample included: in the JAX bf16 step the WavLM
    runs outside the half-precision apply."""
    model.requires_grad_(False).eval()

    def feature_fn(wav: torch.Tensor) -> torch.Tensor:
        x = wav[..., 0] if wav.ndim == 3 else wav
        with torch.autocast(x.device.type, enabled=False):
            hs = model(resample(x.float(), model_sr, slm_sr))
        return torch.cat(hs, dim=-1)

    return feature_fn
