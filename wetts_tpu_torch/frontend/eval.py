"""Frontend evaluation metrics.

Behavioral parity targets:
- polyphone accuracy (wetts/frontend/test_polyphone.py),
- prosody PW/PPH/IPH F1 at rank thresholds >0, >1, >2 with optional
  exclusion of the sentence-final token (wetts/frontend/test_prosody.py:56-103).

The port's own copy of `wetts_tpu/frontend/eval.py`: the PyTorch package
imports nothing of the JAX one.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def binary_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    tp = float(np.sum((y_true == 1) & (y_pred == 1)))
    fp = float(np.sum((y_true == 0) & (y_pred == 1)))
    fn = float(np.sum((y_true == 1) & (y_pred == 0)))
    if tp == 0:
        return 0.0
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    return 2 * precision * recall / (precision + recall)


def prosody_f1(
    ref_ranks: Sequence[Sequence[int]],
    hyp_ranks: Sequence[Sequence[int]],
    exclude_sentence_end: bool = False,
) -> Dict[str, float]:
    """PW/PPH/IPH F1: binary at thresholds rank>0, rank>1, rank>2."""
    ref_flat: List[int] = []
    hyp_flat: List[int] = []
    for r, h in zip(ref_ranks, hyp_ranks):
        n = min(len(r), len(h))
        if exclude_sentence_end:
            n = max(n - 1, 0)
        ref_flat.extend(r[:n])
        hyp_flat.extend(h[:n])
    ref_arr = np.asarray(ref_flat)
    hyp_arr = np.asarray(hyp_flat)
    out = {}
    for name, th in (("PW", 0), ("PPH", 1), ("IPH", 2)):
        out[name] = binary_f1((ref_arr > th).astype(int),
                              (hyp_arr > th).astype(int))
    return out


def polyphone_accuracy(ref: Sequence[int], hyp: Sequence[int]) -> float:
    ref_arr = np.asarray(ref)
    hyp_arr = np.asarray(hyp)
    if len(ref_arr) == 0:
        return 0.0
    return float(np.mean(ref_arr == hyp_arr))
