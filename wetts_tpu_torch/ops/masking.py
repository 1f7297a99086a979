"""Sequence masks and the duration-to-alignment expansion
(port of wetts_tpu/ops/masking.py; reference commons.py:113-136)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] lengths -> [B, max_length] float mask (1.0 where t < length)."""
    pos = torch.arange(max_length, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).float()


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Integer durations [B, T_text] -> monotonic path [B, T_text, T_spec].

    path[b, i, t] = 1 iff cum_dur[i-1] <= t < cum_dur[i], computed as the
    mask of t < cum_dur[i] minus itself shifted by one text position.
    mask: [B, T_text, T_spec].
    """
    t_spec = mask.shape[-1]
    cum = torch.cumsum(duration, dim=-1)
    pos = torch.arange(t_spec, device=duration.device, dtype=cum.dtype)
    path = (pos[None, None, :] < cum[:, :, None]).float()
    path = path - F.pad(path, (0, 0, 1, 0))[:, :-1]
    return path * mask
