"""K3: a chain of dependent matrix products with a requantisation between
them, in int8 and in bf16.

Replaces tools/probe_int8_mxu.py:_chain, the Pallas TPU kernel of the JAX
package's int8 feasibility probe: `hops` times `a <- requant(a @ w)` with
`a [M, K]`, `w [K, K]`:

- int8: int32 sums, `y >> 10` (arithmetic), clip to [-127, 127], int8;
- bf16: f32 sums, `y * (1 / 32)`, cast to bf16.

- `matmul_chain` is the wrapper: on CUDA tensors it packs `a` and `w` into
  the kernel's blocked layout (`pack_rows`) and launches the hand-written
  kernel `csrc/int8_chain.cu` once per hop (tensor-core `wgmma` in the
  kernel's own body; no library product), counting each launch in
  `matmul_chain.launches`: a chain of `hops` hops is `hops` launches. On
  CPU tensors it runs the plain version. It never falls back from the
  kernel.
- `matmul_chain_reference` is the plain PyTorch version. Its int8 sums are
  exact (a float64 product of the integers; an integer product does not run
  on CUDA), so the int8 chain compares with `torch.equal`; the bf16 chain
  takes its f32 sums in another order than the kernel.

What bounds the kernel and how its design answers that is in the note at the
top of the CUDA source; `tools/probe_int8.py` times both chains.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from wetts_tpu_torch.utils import cuda_build

HOPS = 16
ROW_TILE = 256  # rows of a's blocked layout (the kernel's output tile)
COL_TILE = 128  # rows of w^T's blocked layout; K must be a multiple
BLOCK_BYTES = 128  # bytes of K per block: 8 slices of 16 bytes


def matmul_chain_reference(a: torch.Tensor, w: torch.Tensor,
                           hops: int = HOPS) -> torch.Tensor:
    """Plain PyTorch chain; a [M, K] and w [K, K], both int8 or both bf16."""
    if a.dtype == torch.int8:
        wd = w.double()
        for _ in range(hops):
            y = torch.matmul(a.double(), wd).to(torch.int64)
            a = torch.clamp(y >> 10, -127, 127).to(torch.int8)
        return a
    wf = w.float()
    for _ in range(hops):
        a = (torch.matmul(a.float(), wf) * (1.0 / 32.0)).to(torch.bfloat16)
    return a


def pack_rows(x: torch.Tensor, tile: int) -> torch.Tensor:
    """[R, K] int8 or bf16 -> the kernel's blocked layout, bytes
    [R padded to `tile` / tile][K bytes / 128][8 slices][tile rows][16]: the
    128-byte K block of a row tile is one contiguous run, [16-byte slice]
    [row][16 bytes], as the tensor cores read it. Padded rows are zeros."""
    r, k = x.shape
    raw = F.pad(x.contiguous().view(torch.uint8), (0, 0, 0, -r % tile))
    return raw.view(-1, tile, raw.shape[1] // BLOCK_BYTES, BLOCK_BYTES // 16,
                    16).permute(0, 2, 3, 1, 4).contiguous()


def unpack_rows(p: torch.Tensor, r: int, dtype: torch.dtype) -> torch.Tensor:
    """`pack_rows`' inverse: the first `r` rows as [r, K] of `dtype`."""
    tiles, blocks, slices, tile, _ = p.shape
    raw = p.permute(0, 3, 1, 2, 4).reshape(tiles * tile, blocks * slices * 16)
    return raw[:r].contiguous().view(dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("int8_chain")
    for fn in (lib.chain_int8, lib.chain_bf16):
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def matmul_chain(a: torch.Tensor, w: torch.Tensor, hops: int = HOPS
                 ) -> torch.Tensor:
    """`hops` dependent products `a <- requant(a @ w)`; a [M, K], w [K, K],
    both int8 or both bf16, on one device. Returns [M, K] of a's type."""
    if a.ndim != 2 or w.shape != (a.shape[1], a.shape[1]):
        raise ValueError(f"matmul_chain takes a [M, K] and w [K, K]; got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    if a.dtype != w.dtype or a.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"matmul_chain takes int8 or bf16 operands of one "
                         f"type; got {a.dtype} and {w.dtype}")
    if a.device != w.device:
        raise ValueError("matmul_chain: a and w lie on different devices")
    if a.device.type == "cpu":
        return matmul_chain_reference(a, w, hops)
    if a.device.type != "cuda":
        raise ValueError(f"matmul_chain runs on cuda or cpu, not {a.device}")
    m, k = a.shape
    if k % COL_TILE or hops < 0:
        raise ValueError(f"the chain kernel takes K % {COL_TILE} == 0 and "
                         f"hops >= 0; got K={k}, hops={hops}")
    if hops == 0:
        return a.clone()
    # both operands with K contiguous (w transposed), blocked; the packed a
    # and one more buffer are the hops' ping-pong
    ab = pack_rows(a, ROW_TILE)
    wb = pack_rows(w.t(), COL_TILE)
    buf = torch.empty_like(ab)
    out = torch.empty_like(a)
    lib = _library()
    launch = lib.chain_int8 if a.dtype == torch.int8 else lib.chain_bf16
    err = launch(ab.data_ptr(), wb.data_ptr(), buf.data_ptr(),
                 out.data_ptr(), m, k, hops,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_chain launch failed: CUDA error {err}")
    matmul_chain.launches += hops
    return out


matmul_chain.launches = 0
