"""Sequence masks, segment slicing and the duration-to-alignment expansion
(port of wetts_tpu/ops/masking.py; reference commons.py:41-58, 93-95,
113-136)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wetts_tpu_torch.ops import random


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] lengths -> [B, max_length] float mask (1.0 where t < length)."""
    pos = torch.arange(max_length, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).float()


def subsequent_mask(length: int, device=None) -> torch.Tensor:
    """[1, 1, T, T] lower-triangular causal mask (1.0 = attend)."""
    return torch.tril(torch.ones(length, length, device=device))[None, None]


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


def slice_segments(x: torch.Tensor, ids_str: torch.Tensor,
                   segment_size: int) -> torch.Tensor:
    """Fixed-size time segments: x [B, T, C], ids_str [B] int start indices
    -> [B, segment_size, C] (one gather)."""
    idx = ids_str[:, None] + torch.arange(segment_size, device=x.device)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def rand_slice_segments(x: torch.Tensor, x_lengths: torch.Tensor,
                        segment_size: int, generator=None):
    """Random per-utterance segment for decoder training: (segments
    [B, S, C], ids_str [B]). The start is uniform in [0, length - S], clamped
    at 0, drawn as int(u * (max + 1)) in f32 and capped at max."""
    ids_str_max = torch.clamp_min(x_lengths - segment_size, 0)
    u = random.uniform((x.shape[0],), x.device, torch.float32, generator)
    ids_str = (u * (ids_str_max + 1).float()).to(ids_str_max.dtype)
    ids_str = torch.minimum(ids_str, ids_str_max)
    return slice_segments(x, ids_str, segment_size), ids_str
