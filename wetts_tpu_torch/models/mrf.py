"""K1: one HiFi-GAN multi-receptive-field (MRF) stage.

Replaces wetts_tpu/models/mrf_pallas.py:mrf_stage_pallas. For each resblock
branch j and each dilation d: lrelu(0.1) -> conv(k_j, d, same) -> lrelu(0.1)
-> conv(k_j, 1, same) -> +x (ResBlock2: one conv per d); the stage's output
is the mean over the branches. Every conv zero-pads its own input at [0, T),
with T the length of the tensor.

- `mrf_stage` is the wrapper: on a CUDA tensor it launches the hand-written
  kernel `csrc/mrf_stage.cu` once per conv (18 launches for a VITS-base
  stage) and counts each launch in `mrf_stage.launches`; on a CPU tensor it
  runs the plain version. It never falls back from the kernel.
- `mrf_stage_reference` is the plain PyTorch version, the eager ResBlock
  chain through F.conv1d, and the kernel's oracle on the card. It is also
  the differentiable route: the kernel has no backward (as the TPU kernel
  has no VJP), so `mrf_stage` raises on a CUDA tensor when autograd is
  recording and its input or a weight requires grad, and a caller that
  wants gradients (`hifigan.Generator` in training) calls the plain
  version itself.

The kernel does the stage's whole arithmetic itself (no cuDNN, cuBLAS or
torch.matmul): the leaky relu is fused into its input load, and the bias,
the residual add and the branch mean into its epilogue. What bounds it and
how its design answers that is in the note at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from wetts_tpu_torch.models.layers import LRELU_SLOPE, get_padding
from wetts_tpu_torch.utils import cuda_build

# one branch: its (weight [C, C, K], bias [C]) pairs in execution order
Branch = Sequence[Tuple[torch.Tensor, torch.Tensor]]

_STORE, _STORE_SCALED, _ACCUMULATE_SCALED = 0, 1, 2
# kernel sizes the CUDA kernel is instantiated for (HiFi-GAN's resblocks)
KERNEL_TAPS = (3, 5, 7, 9, 11)


def convs_per_branch(resblock_kind: str, dilations: Sequence[int]) -> int:
    return len(dilations) * (2 if resblock_kind == "1" else 1)


def check_stage(stage: Sequence[Branch], resblock_kind: str,
                kernel_sizes: Sequence[int],
                dilations: Sequence[Sequence[int]]) -> None:
    """Raise ValueError unless `stage` fits the topology: per branch j, one
    (weight [C, C, K_j], bias [C]) pair per conv, all on one device, and
    contiguous f32 where that device is a GPU (the kernel reads them by
    pointer). A caller that keeps a stage checks it once, when it is built,
    and passes `checked=True` to `mrf_stage`."""
    if resblock_kind not in ("1", "2"):
        raise ValueError(f"resblock must be '1' or '2', got {resblock_kind!r}")
    if not len(stage) == len(kernel_sizes) == len(dilations):
        raise ValueError("stage, kernel_sizes and dilations differ in length")
    c = stage[0][0][0].shape[0]
    device = stage[0][0][0].device
    for convs, k, dils in zip(stage, kernel_sizes, dilations):
        if len(convs) != convs_per_branch(resblock_kind, dils):
            raise ValueError(f"branch k={k} has {len(convs)} convs")
        for w, b in convs:
            if tuple(w.shape) != (c, c, k) or tuple(b.shape) != (c,):
                raise ValueError(f"conv weight {tuple(w.shape)} / bias "
                                 f"{tuple(b.shape)} do not fit C={c}, k={k}")
            if w.device != device or b.device != device:
                raise ValueError("MRF weights lie on more than one device")
            if device.type == "cuda" and not (
                    w.dtype == b.dtype == torch.float32
                    and w.is_contiguous() and b.is_contiguous()):
                raise ValueError("MRF weights on a GPU must be contiguous f32")


def mrf_stage_reference(h: torch.Tensor, stage: Sequence[Branch],
                        resblock_kind: str, kernel_sizes: Sequence[int],
                        dilations: Sequence[Sequence[int]]) -> torch.Tensor:
    """Plain PyTorch MRF stage: h [B, T, C] -> [B, T, C]."""
    x = h.transpose(1, 2)
    xs = None
    for convs, k, dils in zip(stage, kernel_sizes, dilations):
        cur = x
        it = iter(convs)
        for d in dils:
            w, b = next(it)
            xt = F.conv1d(F.leaky_relu(cur, LRELU_SLOPE), w, b,
                          padding=get_padding(k, d), dilation=d)
            if resblock_kind == "1":
                w, b = next(it)
                xt = F.conv1d(F.leaky_relu(xt, LRELU_SLOPE), w, b,
                              padding=get_padding(k, 1))
            cur = xt + cur
        xs = cur if xs is None else xs + cur
    return (xs / len(stage)).transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("mrf_stage")
    lib.mrf_conv_f32.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    lib.mrf_conv_f32.restype = ctypes.c_int
    return lib


def mrf_stage(h: torch.Tensor, stage: Sequence[Branch], resblock_kind: str,
              kernel_sizes: Sequence[int],
              dilations: Sequence[Sequence[int]],
              checked: bool = False) -> torch.Tensor:
    """One MRF stage, h [B, T, C] -> [B, T, C].

    stage[j]: branch j's (weight [C, C, K_j], bias [C]) pairs in execution
    order (ResBlock1: conv1_0, conv2_0, conv1_1, ...; ResBlock2: conv_0, ...),
    with weight norm already folded. `checked=True` says the caller has
    passed `stage` through `check_stage` since its weights last changed
    place or type; otherwise it is checked here.
    """
    b, t, c = h.shape
    if not checked:
        check_stage(stage, resblock_kind, kernel_sizes, dilations)
    w0 = stage[0][0][0]
    if w0.shape[0] != c or w0.device != h.device:
        raise ValueError(f"MRF weights of C={w0.shape[0]} on {w0.device} do "
                         f"not fit h of C={c} on {h.device}")
    if h.device.type == "cpu":
        return mrf_stage_reference(h, stage, resblock_kind, kernel_sizes,
                                   dilations)
    if h.device.type != "cuda":
        raise ValueError(f"mrf_stage runs on cuda or cpu, not {h.device}")
    if (h.dtype != torch.float32 or c % 4 != 0
            or not set(kernel_sizes) <= set(KERNEL_TAPS)):
        raise ValueError(f"the MRF kernel takes f32, C % 4 == 0 and kernel "
                         f"sizes in {KERNEL_TAPS}; got {h.dtype}, C={c}, "
                         f"kernel sizes {tuple(kernel_sizes)}")
    if torch.is_grad_enabled() and (h.requires_grad or any(
            w.requires_grad or bias.requires_grad
            for convs in stage for w, bias in convs)):
        raise RuntimeError(
            "the MRF kernel has no backward: where a gradient is wanted, "
            "call mrf_stage_reference (Generator.forward does so itself); "
            "for inference run under torch.no_grad()")
    h = h.contiguous()

    lib = _library()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    scale = 1.0 / len(stage)
    out = torch.empty_like(h)
    y, xb = torch.empty_like(h), torch.empty_like(h)

    def conv(src, wb, k, d, res, dst, mode):
        w, bias = wb
        err = lib.mrf_conv_f32(
            src.data_ptr(), w.data_ptr(), bias.data_ptr(),
            None if res is None else res.data_ptr(), dst.data_ptr(),
            b, t, c, k, d, LRELU_SLOPE, scale, mode, stream)
        if err != 0:
            raise RuntimeError(f"mrf_conv_f32 launch failed: CUDA error {err}")
        mrf_stage.launches += 1

    for j, (convs, k, dils) in enumerate(zip(stage, kernel_sizes, dilations)):
        cur = h
        it = iter(convs)
        for i, d in enumerate(dils):
            if i == len(dils) - 1:
                dst = out
                mode = _STORE_SCALED if j == 0 else _ACCUMULATE_SCALED
            else:
                # ResBlock1 writes its residual sum in place (each element is
                # read and written by one thread); ResBlock2's conv reads its
                # own output buffer's neighbours, so it ping-pongs
                dst = xb if (resblock_kind == "1" or cur is not xb) else y
                mode = _STORE
            if resblock_kind == "1":
                conv(cur, next(it), k, d, None, y, _STORE)
                conv(y, next(it), k, 1, cur, dst, mode)
            else:
                conv(cur, next(it), k, d, cur, dst, mode)
            cur = dst
    return out


mrf_stage.launches = 0
