"""K2: monotonic alignment search (MAS), the training step's aligner.

Replaces wetts_tpu/ops/mas_pallas.py:maximum_path_pallas. Per utterance a
Viterbi-style DP over neg_cent [T_spec, T_text],

    v[y, x] = neg_cent[y, x] + max(v[y-1, x-1], v[y-1, x]),

with x == y forbidden from above and x == 0 enterable only at y == 0, then
backtracking from (t_spec - 1, t_text - 1), stepping left when index == y or
`v[y-1, index] < v[y-1, index-1]`. Exact (same -1e9 masking and tie rule as
the JAX package), no gradient.

- `maximum_path` is the wrapper: on a CUDA tensor it launches the
  hand-written kernel `csrc/mas.cu` once (forward DP and backtracking in one
  launch) and counts the launch in `maximum_path.launches`; on a CPU tensor
  it runs the plain version. It never falls back from the kernel. The input
  preparation (lengths from the mask, the -1e9 fill) and the final `* mask`
  are plain PyTorch, as they lie outside the Pallas body in the JAX package;
  the lengths stay on the device and nothing synchronises with the host.
- `maximum_path_reference` is the plain PyTorch version, a loop over spec
  frames on [B, T_text] rows and the reverse walk: the kernel's oracle.

Shapes: neg_cent, mask [B, T_spec, T_text] -> float 0/1 path of that shape.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from wetts_tpu_torch.utils import cuda_build

_NEG = -1e9
# dynamic shared memory the kernel may ask for (an H100 block can opt in to
# 227 KB); above it the decision bits go to a scratch buffer instead
SHARED_LIMIT_BYTES = 200 * 1024


def _prepare(neg_cent: torch.Tensor, mask: torch.Tensor
             ) -> Tuple[torch.Tensor, ...]:
    """(masked scores, mask as f32, t_text [B] int32, t_spec [B] int32);
    lengths are clamped to at least 1."""
    neg_cent = neg_cent.float()
    mask_f = mask.float()
    t_text = torch.clamp_min(mask_f[:, 0, :].sum(dim=1).to(torch.int32), 1)
    t_spec = torch.clamp_min(mask_f[:, :, 0].sum(dim=1).to(torch.int32), 1)
    masked = neg_cent * mask_f + (1.0 - mask_f) * _NEG
    return masked, mask_f, t_text, t_spec


@torch.no_grad()
def maximum_path_reference(neg_cent: torch.Tensor, mask: torch.Tensor
                           ) -> torch.Tensor:
    """Plain PyTorch MAS: the forward table row by row, then the reverse
    walk carrying each utterance's text index."""
    masked, mask_f, t_text, t_spec_len = _prepare(neg_cent, mask)
    b, t_spec, t_x = masked.shape
    dev = masked.device
    xs = torch.arange(t_x, device=dev)
    neg = torch.tensor(_NEG, device=dev)
    t_text, t_spec_len = t_text.long(), t_spec_len.long()

    value = torch.empty_like(masked)
    v_prev = torch.full((b, t_x), _NEG, device=dev)
    for y in range(t_spec):
        fill = torch.full((b, 1), 0.0 if y == 0 else _NEG, device=dev)
        v_left = torch.cat([fill, v_prev[:, :-1]], dim=1)
        v_up = torch.where(xs[None, :] == y, neg, v_prev)
        v_prev = masked[:, y] + torch.maximum(v_left, v_up)
        value[:, y] = v_prev

    path = torch.empty_like(masked)
    index = torch.zeros(b, dtype=torch.long, device=dev)
    for y in range(t_spec - 1, -1, -1):
        # (re)initialise at each utterance's last valid row
        index = torch.where(y == t_spec_len - 1, t_text - 1, index)
        active = y < t_spec_len
        path[:, y] = ((xs[None, :] == index[:, None])
                      & active[:, None]).float()
        v_prev_row = value[:, max(y - 1, 0)]
        v_at = v_prev_row.gather(1, index[:, None])[:, 0]
        v_left = v_prev_row.gather(
            1, torch.clamp_min(index - 1, 0)[:, None])[:, 0]
        dec = ((index == y) | (v_at < v_left)) & (index > 0) & active
        index = index - dec.long()
    return path * mask_f


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("mas")
    lib.mas_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.mas_f32.restype = ctypes.c_int
    lib.mas_shared_bytes.argtypes = [ctypes.c_int] * 3
    lib.mas_shared_bytes.restype = ctypes.c_longlong
    return lib


def _launch(masked: torch.Tensor, t_text: torch.Tensor,
            t_spec_len: torch.Tensor) -> torch.Tensor:
    """The kernel alone: masked scores [B, T_spec, T_text] (contiguous f32
    on the GPU) and int32 lengths [B] -> the 0/1 path, every cell written."""
    b, t_spec, t_x = masked.shape
    lib = _library()
    scratch = None
    if lib.mas_shared_bytes(t_spec, t_x, 1) > SHARED_LIMIT_BYTES:
        if lib.mas_shared_bytes(t_spec, t_x, 0) > SHARED_LIMIT_BYTES:
            raise ValueError(f"the MAS kernel stages its rows in shared "
                             f"memory; T_text={t_x} is too wide for it")
        scratch = torch.empty((b, t_spec, (t_x + 31) // 32 + 1),
                              dtype=torch.int32, device=masked.device)
    path = torch.empty_like(masked)
    with torch.cuda.device(masked.device):
        err = lib.mas_f32(
            masked.data_ptr(), t_text.data_ptr(), t_spec_len.data_ptr(),
            path.data_ptr(), None if scratch is None else scratch.data_ptr(),
            b, t_spec, t_x,
            torch.cuda.current_stream(masked.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mas_f32 launch failed: CUDA error {err}")
    maximum_path.launches += 1
    return path


@torch.no_grad()
def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Best monotonic alignment path maximizing the sum of neg_cent.

    neg_cent: [B, T_spec, T_text] scores; mask: the same shape, the outer
    product of the spec and text masks. Returns the float 0/1 path, zero
    outside the mask; it never requires grad (MAS has no gradient).
    """
    if neg_cent.ndim != 3 or mask.shape != neg_cent.shape:
        raise ValueError(f"maximum_path takes neg_cent and mask of one "
                         f"[B, T_spec, T_text] shape; got "
                         f"{tuple(neg_cent.shape)}, {tuple(mask.shape)}")
    if mask.device != neg_cent.device:
        raise ValueError(f"neg_cent on {neg_cent.device}, mask on "
                         f"{mask.device}")
    if neg_cent.device.type == "cpu":
        return maximum_path_reference(neg_cent, mask)
    if neg_cent.device.type != "cuda":
        raise ValueError(f"maximum_path runs on cuda or cpu, not "
                         f"{neg_cent.device}")
    if 0 in neg_cent.shape:
        raise ValueError(f"empty MAS input {tuple(neg_cent.shape)}")
    masked, mask_f, t_text, t_spec_len = _prepare(neg_cent, mask)
    return _launch(masked.contiguous(), t_text, t_spec_len) * mask_f


maximum_path.launches = 0
