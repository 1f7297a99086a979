"""The frontend's BERT scorer in plain PyTorch, for inference: a frozen copy
of the port's `models/bert_frontend.py` forward and `frontend/scorer.py`
(reference wetts/frontend/model.py:21-73): a bert-base-chinese-wide BERT
(post-LN layers, exact GELU, key padding -1e9 before an f32 softmax), one
torch-style transformer layer (post-LN, relu FFN, LayerNorm eps 1e-6) and
two token-level heads, softmax over each. The module tree keeps the
reference checkpoint's state-dict names, so one state dict loads into the
program's FrontendModel and into this one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

TRANSFORM_LN_EPS = 1e-6


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 21128  # bert-base-chinese
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


def _attention(q, k, v, n_heads: int) -> torch.Tensor:
    """Multi-head attention over [B, T, D] projections, every key valid."""
    b, t, d = q.shape
    hd = d // n_heads

    def split(a):
        return a.reshape(b, t, n_heads, hd).transpose(1, 2)

    scores = torch.matmul(split(q), split(k).transpose(-1, -2))
    probs = torch.softmax(scores / math.sqrt(hd), dim=-1)
    return torch.matmul(probs, split(v)).transpose(1, 2).reshape(b, t, d)


class _Proj(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)


class _Output(nn.Module):
    def __init__(self, d_in: int, hidden: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=eps)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class _Attention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.self = _Proj(cfg.hidden_size)
        self.output = _Output(cfg.hidden_size, cfg.hidden_size,
                              cfg.layer_norm_eps)

    def forward(self, x):
        p = self.self
        return self.output(_attention(p.query(x), p.key(x), p.value(x),
                                      self.num_heads), x)


class _Intermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


class _Layer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = _Attention(cfg)
        self.intermediate = _Intermediate(cfg)
        self.output = _Output(cfg.intermediate_size, cfg.hidden_size,
                              cfg.layer_norm_eps)

    def forward(self, x):
        x = self.attention(x)
        return self.output(F.gelu(self.intermediate.dense(x)), x)


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.LayerNorm(self.word_embeddings(ids)
                              + self.position_embeddings(pos)[None]
                              + self.token_type_embeddings(
                                  torch.zeros_like(ids)))


class _Layers(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(cfg) for _ in range(cfg.num_layers))


class _Bert(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Layers(cfg)

    def forward(self, ids):
        x = self.embeddings(ids)
        for layer in self.encoder.layer:
            x = layer(x)
        return x


class _SelfAttn(nn.Module):
    def __init__(self, d: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, x):
        q, k, v = F.linear(x, self.in_proj_weight,
                           self.in_proj_bias).chunk(3, dim=-1)
        return self.out_proj(_attention(q, k, v, self.nhead))


class _Transform(nn.Module):
    def __init__(self, d: int, nhead: int, ffn: int):
        super().__init__()
        self.self_attn = _SelfAttn(d, nhead)
        self.linear1 = nn.Linear(d, ffn)
        self.linear2 = nn.Linear(ffn, d)
        self.norm1 = nn.LayerNorm(d, eps=TRANSFORM_LN_EPS)
        self.norm2 = nn.LayerNorm(d, eps=TRANSFORM_LN_EPS)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class FrontendModel(nn.Module):
    """BERT, the transform layer (8 heads, FFN 2048 for bert-base) and the
    polyphone and prosody heads."""

    def __init__(self, num_polyphones: int, num_prosody: int,
                 bert: BertConfig = BertConfig(), transform_heads: int = 8,
                 transform_ffn: int = 2048):
        super().__init__()
        self.bert = _Bert(bert)
        self.transform = _Transform(bert.hidden_size, transform_heads,
                                    transform_ffn)
        self.phone_classifier = nn.Linear(bert.hidden_size, num_polyphones)
        self.prosody_classifier = nn.Linear(bert.hidden_size, num_prosody)

    def forward(self, ids):
        h = self.transform(self.bert(ids))
        return self.phone_classifier(h), self.prosody_classifier(h)


class Scorer:
    """token ids [T] -> (polyphone posteriors [T, P], prosody posteriors
    [T, R]) as numpy arrays."""

    def __init__(self, model: FrontendModel):
        self.model = model.eval()

    @torch.no_grad()
    def __call__(self, token_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        dev = next(self.model.parameters()).device
        ids = torch.as_tensor(np.asarray(token_ids), dtype=torch.long,
                              device=dev)[None]
        phone, prosody = self.model(ids)
        return (torch.softmax(phone[0], -1).cpu().numpy(),
                torch.softmax(prosody[0], -1).cpu().numpy())
