"""K3: a chain of dependent matrix products with a requantisation between
them, in int8 and in bf16.

Replaces tools/probe_int8_mxu.py:_chain, the Pallas TPU kernel of the JAX
package's int8 feasibility probe: `hops` times `a <- requant(a @ w)` with
`a [M, K]`, `w [K, K]`:

- int8: int32 sums, `y >> 10` (arithmetic), clip to [-127, 127], int8;
- bf16: f32 sums, `y * (1 / 32)`, cast to bf16.

- `matmul_chain` is the wrapper: on CUDA tensors it launches the hand-written
  kernel `csrc/int8_chain.cu` once for the whole chain (tensor-core
  `mma.sync` in the kernel's own body; no library product) and counts the
  launch in `matmul_chain.launches`; on CPU tensors it runs the plain
  version. It never falls back from the kernel.
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

from wetts_tpu_torch.utils import cuda_build

HOPS = 16


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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("int8_chain")
    for fn in (lib.chain_int8, lib.chain_bf16):
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
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
    step = 256 if a.dtype == torch.int8 else 128
    if k % step or k > 1024 or hops < 0:
        raise ValueError(f"the chain kernel takes K % {step} == 0 and "
                         f"K <= 1024 for {a.dtype}; got K={k}")
    a = a.contiguous()
    wt = w.t().contiguous()  # both operands with K contiguous
    out = torch.empty_like(a)
    lib = _library()
    launch = lib.chain_int8 if a.dtype == torch.int8 else lib.chain_bf16
    err = launch(a.data_ptr(), wt.data_ptr(), out.data_ptr(), m, k, hops,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_chain launch failed: CUDA error {err}")
    matmul_chain.launches += 1
    return out


matmul_chain.launches = 0
