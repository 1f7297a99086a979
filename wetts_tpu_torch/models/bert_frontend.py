"""BERT-based unified Mandarin frontend model (prosody + polyphone).

Port of wetts_tpu/models/bert_frontend.py. Behavioral parity target:
wetts/frontend/model.py:21-73 — a frozen Chinese BERT (bert-base-chinese
width by default; the reference freezes all BERT params, :30-31) followed by
ONE trainable torch-style TransformerEncoderLayer (post-LN, relu FFN) and
two token-level linear heads (polyphone classes, prosody ranks). `export`
(:63-73) applies softmax and builds the attention mask from bare ids.

The module tree keeps the reference's state-dict names (`bert.embeddings.*`,
`bert.encoder.layer.N.attention.self.{query,key,value}`,
`transform.self_attn.in_proj_weight`, `transform.linear1`,
`phone_classifier`, ...), so `convert_frontend_torch` (here, and its
original in `wetts_tpu.models.bert_frontend`) reads a port state_dict as it
reads a reference checkpoint; `utils/convert.py:frontend_params_from_jax`
is its inverse.

Attention is plain tensor code with the JAX model's numerics: scores in
f32, key padding filled with -1e9 (not -inf), softmax in f32. Layer norms
take the JAX model's epsilons: `layer_norm_eps` in BERT and flax's default
1e-6 in the transform layer (torch's TransformerEncoderLayer takes 1e-5).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# flax nn.LayerNorm's default epsilon (the transform layer's norms)
FLAX_LN_EPS = 1e-6


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

    @classmethod
    def tiny(cls, vocab_size: int = 128) -> "BertConfig":
        return cls(vocab_size=vocab_size, hidden_size=32, num_layers=2,
                   num_heads=2, intermediate_size=64, max_position=64)


def _attention(q, k, v, key_mask, n_heads: int) -> torch.Tensor:
    """Multi-head attention over [B, T, D] projections; key positions where
    key_mask <= 0 get -1e9 before an f32 softmax."""
    b, t, d = q.shape
    hd = d // n_heads

    def split(a):
        return a.reshape(b, t, n_heads, hd).transpose(1, 2)

    scores = torch.matmul(split(q).float(), split(k).float().transpose(-1, -2))
    scores = scores / math.sqrt(hd)
    scores = scores.masked_fill(~(key_mask[:, None, None, :] > 0), -1e9)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(probs.float(), split(v).float()).to(q.dtype)
    return out.transpose(1, 2).reshape(b, t, d)


class BertSelfAttentionProj(nn.Module):
    """`attention.self`: the query, key and value projections."""

    def __init__(self, hidden: int):
        super().__init__()
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)


class BertSelfOutput(nn.Module):
    """`attention.output` / `output`: dense then residual LayerNorm."""

    def __init__(self, d_in: int, hidden: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=eps)

    def forward(self, h: torch.Tensor, residual: torch.Tensor):
        return self.LayerNorm(residual + self.dense(h))


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.self = BertSelfAttentionProj(cfg.hidden_size)
        self.output = BertSelfOutput(cfg.hidden_size, cfg.hidden_size,
                                     cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        p = self.self
        attn = _attention(p.query(x), p.key(x), p.value(x), mask,
                          self.num_heads)
        return self.output(attn, x)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(x))  # exact erf GELU


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertSelfOutput(cfg.intermediate_size, cfg.hidden_size,
                                     cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, mask)
        return self.output(self.intermediate(x), x)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids, token_type_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos)[None]
             + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(x)


class BertEncoderLayers(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_layers))


class BertEncoder(nn.Module):
    """The BERT encoder (HuggingFace `BertModel` names, no pooler)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoderLayers(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.encoder.layer:
            x = layer(x, attention_mask)
        return x


class TorchMultiheadAttention(nn.Module):
    """`self_attn` of torch's TransformerEncoderLayer: a fused in_proj
    [3d, d] then out_proj, under torch's parameter names."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor):
        q, k, v = F.linear(x, self.in_proj_weight,
                           self.in_proj_bias).chunk(3, dim=-1)
        return self.out_proj(_attention(q, k, v, key_mask, self.nhead))


class TorchTransformerLayer(nn.Module):
    """torch.nn.TransformerEncoderLayer equivalent (post-LN, relu FFN)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 p_dropout: float = 0.1):
        super().__init__()
        self.self_attn = TorchMultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.dropout = nn.Dropout(p_dropout)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor):
        x = self.norm1(x + self.dropout(self.self_attn(x, key_mask)))
        h = self.linear2(self.dropout(F.relu(self.linear1(x))))
        return self.norm2(x + self.dropout(h))


class FrontendModel(nn.Module):
    def __init__(self, num_polyphones: int, num_prosody: int,
                 bert: BertConfig, transform_heads: int = 8,
                 transform_ffn: int = 2048):
        """Transform-layer dims of the reference: bert-base-chinese ->
        (8, 2048), TinyBERT-4L -> (12, 1200) (model.py:33-47)."""
        super().__init__()
        self.bert = BertEncoder(bert)
        self.transform = TorchTransformerLayer(bert.hidden_size,
                                               transform_heads, transform_ffn)
        self.phone_classifier = nn.Linear(bert.hidden_size, num_polyphones)
        self.prosody_classifier = nn.Linear(bert.hidden_size, num_prosody)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        # the reference freezes BERT (model.py:30-31)
        with torch.no_grad():
            h = self.bert(input_ids, attention_mask, token_type_ids)
        h = self.transform(h, attention_mask)
        return self.phone_classifier(h), self.prosody_classifier(h)

    def export(self, input_ids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Bare-ids path with softmax outputs (reference :63-73)."""
        phone, prosody = self(input_ids, torch.ones_like(input_ids))
        return torch.softmax(phone, -1), torch.softmax(prosody, -1)


# ---------------------------------------------------------------------------
# reference state_dicts -> flax trees (wetts_tpu/models/bert_frontend.py:182-260)
# ---------------------------------------------------------------------------


def convert_hf_bert(state_dict: Dict[str, np.ndarray], cfg: BertConfig
                    ) -> Dict:
    """HuggingFace BertModel state_dict -> the flax BertEncoder's params
    (numpy leaves)."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}

    def lin(prefix):
        return {"kernel": sd[prefix + ".weight"].T,
                "bias": sd[prefix + ".bias"]}

    def ln(prefix):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    params = {
        "word_embeddings": {
            "embedding": sd["embeddings.word_embeddings.weight"]},
        "position_embeddings": {
            "embedding": sd["embeddings.position_embeddings.weight"]},
        "token_type_embeddings": {
            "embedding": sd["embeddings.token_type_embeddings.weight"]},
        "embeddings_norm": ln("embeddings.LayerNorm"),
    }
    for i in range(cfg.num_layers):
        b = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "attention": {
                "query": lin(f"{b}.attention.self.query"),
                "key": lin(f"{b}.attention.self.key"),
                "value": lin(f"{b}.attention.self.value"),
                "output": lin(f"{b}.attention.output.dense"),
            },
            "attention_norm": ln(f"{b}.attention.output.LayerNorm"),
            "intermediate": lin(f"{b}.intermediate.dense"),
            "ffn_output": lin(f"{b}.output.dense"),
            "output_norm": ln(f"{b}.output.LayerNorm"),
        }
    return params


def convert_frontend_torch(state_dict: Dict[str, np.ndarray]):
    """Full reference FrontendModel state_dict -> (params, meta), the port's
    own copy of `wetts_tpu.models.bert_frontend.convert_frontend_torch`
    with numpy leaves.

    Accepts the tensors of wetts/frontend/model.py:21-49 under their
    state-dict names (`bert.*`, `transform.*`, `phone_classifier`,
    `prosody_classifier`): the naming of the torch checkpoints, of the
    exported final.onnx initializers (export_forward traces every
    parameter, so nothing is missing from the ONNX bundle) and of the
    port's `FrontendModel`.

    Returns (params, dict(bert=BertConfig, num_polyphones, num_prosody,
    transform_heads, transform_ffn)); head counts follow the reference's
    d_model dispatch (model.py:33-42: 768 -> transform nhead 8,
    312 (TinyBERT) -> 12; HF BERT heads are hidden//64).
    `utils/convert.py:frontend_params_from_jax` takes both to the port's
    state_dict.
    """
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    bert_sd = {k[len("bert."):]: v for k, v in sd.items()
               if k.startswith("bert.") and ".pooler." not in k}
    hidden = bert_sd["embeddings.word_embeddings.weight"].shape[1]
    n_layers = 1 + max(int(k.split(".")[2]) for k in bert_sd
                       if k.startswith("encoder.layer."))
    cfg = BertConfig(
        vocab_size=bert_sd["embeddings.word_embeddings.weight"].shape[0],
        hidden_size=hidden,
        num_layers=n_layers,
        num_heads=max(1, hidden // 64) if hidden % 64 == 0 else 12,
        intermediate_size=bert_sd[
            "encoder.layer.0.intermediate.dense.weight"].shape[0],
        max_position=bert_sd[
            "embeddings.position_embeddings.weight"].shape[0],
        type_vocab_size=bert_sd[
            "embeddings.token_type_embeddings.weight"].shape[0])

    def lin(prefix):
        return {"kernel": sd[prefix + ".weight"].T.astype(np.float32),
                "bias": sd[prefix + ".bias"].astype(np.float32)}

    def norm(prefix):
        return {"scale": sd[prefix + ".weight"].astype(np.float32),
                "bias": sd[prefix + ".bias"].astype(np.float32)}

    params = {
        "bert": convert_hf_bert(bert_sd, cfg),
        "transform": {
            "in_proj": {
                "kernel": sd["transform.self_attn.in_proj_weight"
                             ].T.astype(np.float32),
                "bias": sd["transform.self_attn.in_proj_bias"
                           ].astype(np.float32)},
            "out_proj": lin("transform.self_attn.out_proj"),
            "linear1": lin("transform.linear1"),
            "linear2": lin("transform.linear2"),
            "norm1": norm("transform.norm1"),
            "norm2": norm("transform.norm2"),
        },
        "phone_classifier": lin("phone_classifier"),
        "prosody_classifier": lin("prosody_classifier"),
    }
    meta = {
        "bert": cfg,
        "num_polyphones": sd["phone_classifier.weight"].shape[0],
        "num_prosody": sd["prosody_classifier.weight"].shape[0],
        "transform_heads": 12 if hidden == 312 else 8,
        "transform_ffn": sd["transform.linear1.weight"].shape[0],
    }
    return params, meta
