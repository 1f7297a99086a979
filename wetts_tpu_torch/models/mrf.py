"""K1: one HiFi-GAN multi-receptive-field (MRF) stage.

Replaces wetts_tpu/models/mrf_pallas.py:mrf_stage_pallas. For each resblock
branch j and each dilation d: lrelu(0.1) -> conv(k_j, d, same) -> lrelu(0.1)
-> conv(k_j, 1, same) -> +x (ResBlock2: one conv per d); the stage's output
is the mean over the branches. Every conv zero-pads its own input at [0, T),
with T the length of the tensor.

- `mrf_stage` is the wrapper: on a CUDA tensor it launches the hand-written
  kernel `csrc/mrf_stage.cu` once per conv (18 launches for a VITS-base
  stage) and counts each launch in `mrf_stage.launches`; on a CPU tensor it
  runs the plain version. It never falls back from the kernel. The kernel
  has an f32 and a bf16 instance (activations and weights of one type, f32
  sums); the tensor's type picks it.
- `mrf_stage_int8` runs the same stage through the int8 convolution of
  `models/quant.py` (`csrc/int8_conv.cu`): per conv one activation-scale
  launch and one conv launch, counted in `row_scale.launches` and
  `int8_conv1d.launches`; residual, branch scale and accumulation are the
  conv's epilogue, as in K1. `mrf_stage_int8_reference` is its plain version.
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
from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

from wetts_tpu_torch.models.layers import LRELU_SLOPE, get_padding
from wetts_tpu_torch.models.quant import (
    ACCUMULATE_SCALED,
    STORE,
    STORE_SCALED,
    QuantConv1d,
    int8_conv1d,
    int8_conv1d_reference,
)
from wetts_tpu_torch.utils import cuda_build

# one branch: its (weight [C, C, K], bias [C]) pairs in execution order
Branch = Sequence[Tuple[torch.Tensor, torch.Tensor]]

# kernel sizes the CUDA kernel is instantiated for (HiFi-GAN's resblocks)
KERNEL_TAPS = (3, 5, 7, 9, 11)


def convs_per_branch(resblock_kind: str, dilations: Sequence[int]) -> int:
    return len(dilations) * (2 if resblock_kind == "1" else 1)


def check_stage(stage: Sequence[Branch], resblock_kind: str,
                kernel_sizes: Sequence[int],
                dilations: Sequence[Sequence[int]]) -> None:
    """Raise ValueError unless `stage` fits the topology: per branch j, one
    (weight [C, C, K_j], bias [C]) pair per conv, all on one device, and
    contiguous and all f32 or all bf16 where that device is a GPU (the
    kernel reads them by pointer). A caller that keeps a stage checks it once, when it is built,
    and passes `checked=True` to `mrf_stage`."""
    if resblock_kind not in ("1", "2"):
        raise ValueError(f"resblock must be '1' or '2', got {resblock_kind!r}")
    if not len(stage) == len(kernel_sizes) == len(dilations):
        raise ValueError("stage, kernel_sizes and dilations differ in length")
    c = stage[0][0][0].shape[0]
    device, dtype = stage[0][0][0].device, stage[0][0][0].dtype
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
                    w.dtype == b.dtype == dtype
                    and dtype in (torch.float32, torch.bfloat16)
                    and w.is_contiguous() and b.is_contiguous()):
                raise ValueError("MRF weights on a GPU must be contiguous "
                                 "and all f32 or all bf16")


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
    for fn in (lib.mrf_conv_f32, lib.mrf_conv_bf16):
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _run_stage(h: torch.Tensor, stage, resblock_kind: str,
               kernel_sizes: Sequence[int],
               dilations: Sequence[Sequence[int]],
               conv: Callable) -> torch.Tensor:
    """Drive one stage through `conv(src, conv_j, k, d, res, dst, mode)`, a
    launch that writes `dst (op)= conv_j(lrelu(src)) + bias + res`: 3
    buffers beside the input, the branch mean as the last conv's mode."""
    out = torch.empty_like(h)
    y, xb = torch.empty_like(h), torch.empty_like(h)
    for j, (convs, k, dils) in enumerate(zip(stage, kernel_sizes, dilations)):
        cur = h
        it = iter(convs)
        for i, d in enumerate(dils):
            if i == len(dils) - 1:
                dst = out
                mode = STORE_SCALED if j == 0 else ACCUMULATE_SCALED
            else:
                # ResBlock1 writes its residual sum in place (each element is
                # read and written by one thread); ResBlock2's conv reads its
                # own output buffer's neighbours, so it ping-pongs
                dst = xb if (resblock_kind == "1" or cur is not xb) else y
                mode = STORE
            if resblock_kind == "1":
                conv(cur, next(it), k, d, None, y, STORE)
                conv(y, next(it), k, 1, cur, dst, mode)
            else:
                conv(cur, next(it), k, d, cur, dst, mode)
            cur = dst
    return out


def _refuse_gradient(h: torch.Tensor, tensors, name: str) -> None:
    if torch.is_grad_enabled() and (h.requires_grad or any(
            t.requires_grad for t in tensors)):
        raise RuntimeError(
            f"{name} has no backward: where a gradient is wanted, "
            "call mrf_stage_reference (Generator.forward does so itself); "
            "for inference run under torch.no_grad()")


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
    if (h.dtype not in (torch.float32, torch.bfloat16) or w0.dtype != h.dtype
            or c % 4 != 0 or not set(kernel_sizes) <= set(KERNEL_TAPS)):
        raise ValueError(f"the MRF kernel takes f32 or bf16 with weights of "
                         f"the same type, C % 4 == 0 and kernel sizes in "
                         f"{KERNEL_TAPS}; got {h.dtype} with {w0.dtype} "
                         f"weights, C={c}, kernel sizes "
                         f"{tuple(kernel_sizes)}")
    _refuse_gradient(h, (t for convs in stage for wb in convs for t in wb),
                     "the MRF kernel")
    h = h.contiguous()

    lib = _library()
    launch = (lib.mrf_conv_f32 if h.dtype == torch.float32
              else lib.mrf_conv_bf16)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    scale = 1.0 / len(stage)

    def conv(src, wb, k, d, res, dst, mode):
        w, bias = wb
        err = launch(
            src.data_ptr(), w.data_ptr(), bias.data_ptr(),
            None if res is None else res.data_ptr(), dst.data_ptr(),
            b, t, c, k, d, LRELU_SLOPE, scale, mode, stream)
        if err != 0:
            raise RuntimeError(f"mrf_conv launch failed: CUDA error {err}")
        mrf_stage.launches += 1

    return _run_stage(h, stage, resblock_kind, kernel_sizes, dilations, conv)


mrf_stage.launches = 0


# one branch of the int8 stage: its QuantConv1d objects in execution order
QuantBranch = Sequence[QuantConv1d]


def quantize_stage(stage: Sequence[Branch], dtype: torch.dtype
                   ) -> Sequence[QuantBranch]:
    """int8 form of a stage's folded f32 (weight, bias) pairs; the biases are
    kept in `dtype`, the type of the activations the stage will see."""
    return [[QuantConv1d(w, b, dtype) for w, b in convs] for convs in stage]


def mrf_stage_int8_reference(h: torch.Tensor, stage: Sequence[QuantBranch],
                             resblock_kind: str,
                             dilations: Sequence[Sequence[int]]
                             ) -> torch.Tensor:
    """Plain PyTorch int8 MRF stage, h [B, T, C] -> [B, T, C] in h.dtype:
    every conv through `int8_conv1d_reference`, the sums and the branch
    mean (each branch times 1 / n, then added) in h.dtype."""
    scale = 1.0 / len(stage)
    xs = None
    for convs, dils in zip(stage, dilations):
        cur = h
        it = iter(convs)
        for d in dils:
            xt = int8_conv1d_reference(cur, next(it), d, LRELU_SLOPE)
            if resblock_kind == "1":
                xt = int8_conv1d_reference(xt, next(it), 1, LRELU_SLOPE)
            cur = xt + cur
        xs = cur * scale if xs is None else xs + cur * scale
    return xs


def mrf_stage_int8(h: torch.Tensor, stage: Sequence[QuantBranch],
                   resblock_kind: str,
                   dilations: Sequence[Sequence[int]]) -> torch.Tensor:
    """One MRF stage with int8 convolutions, h [B, T, C] f32 or bf16 ->
    [B, T, C]. On a CUDA tensor every conv is one `row_scale` and one
    `int8_conv1d` launch (counted there); on a CPU tensor the plain
    version runs."""
    if resblock_kind not in ("1", "2"):
        raise ValueError(f"resblock must be '1' or '2', got {resblock_kind!r}")
    if len(stage) != len(dilations) or any(
            len(convs) != convs_per_branch(resblock_kind, d)
            for convs, d in zip(stage, dilations)):
        raise ValueError("the int8 stage does not fit the topology")
    if h.device.type == "cpu":
        return mrf_stage_int8_reference(h, stage, resblock_kind, dilations)
    _refuse_gradient(h, (), "the int8 MRF stage")
    h = h.contiguous()
    scale = 1.0 / len(stage)

    def conv(src, qconv, k, d, res, dst, mode):
        int8_conv1d(src, qconv, d, LRELU_SLOPE, residual=res, out=dst,
                    mode=mode, branch_scale=scale)

    return _run_stage(h, stage, resblock_kind,
                      [convs[0].taps for convs in stage], dilations, conv)
