"""Reader of the `params.npz` bundle format (wetts_tpu/utils/params_io.py).

Keys are jax keystr paths like "['enc_p']['proj']['kernel']"; bf16 leaves
are stored as a uint16 view under a "__bf16__" key prefix. This reader needs
neither jax nor ml_dtypes: it widens bf16 leaves to float32, which is exact.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

_BF16 = "__bf16__"


def bf16_bits_to_float32(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> the float32 values they denote."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


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
