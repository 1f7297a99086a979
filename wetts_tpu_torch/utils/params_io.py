"""The `params.npz` bundle format (wetts_tpu/utils/params_io.py), both ways.

Keys are jax keystr paths like "['enc_p']['proj']['kernel']"; bf16 leaves
are stored as a uint16 view under a "__bf16__" key prefix. Neither side
needs jax or ml_dtypes: the writer takes bf16 leaves as torch tensors (or
numpy arrays of an ml_dtypes bfloat16 dtype, by name) and the reader widens
them to float32, which is exact.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

_BF16 = "__bf16__"


def bf16_bits_to_float32(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> the float32 values they denote."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _flatten(node: Any, key: str = ""):
    """(keystr, leaf) pairs of a nested dict, depth first in key order
    (jax.tree_util's order for dicts)."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _flatten(node[k], f"{key}['{k}']")
    else:
        yield key, node


def save_params_npz(path: str, params: Any) -> None:
    """Nested dict of numpy arrays or torch tensors -> params.npz, the file
    `wetts_tpu.utils.params_io.load_params_npz` reads."""
    out = {}
    for key, leaf in _flatten(params):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                key = _BF16 + key
                arr = leaf.view(torch.int16).numpy().view(np.uint16)
            else:
                arr = leaf.numpy()
        else:
            arr = np.asarray(leaf)
            if arr.dtype.name == "bfloat16":
                key, arr = _BF16 + key, arr.view(np.uint16)
        out[key] = arr
    np.savez(path, **out)


def load_params_npz(path: str) -> Dict:
    """params.npz -> nested dict of numpy arrays (bf16 widened to f32)."""
    tree: Dict = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            arr = data[key]
            if key.startswith(_BF16):
                arr = bf16_bits_to_float32(arr)
            parts = re.findall(r"\['([^']+)'\]", key)
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return tree
