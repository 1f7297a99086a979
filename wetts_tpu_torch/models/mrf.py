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
  is an implicit GEMM on the H100's tensor cores (`wgmma`), with an f32 and
  a bf16 instance (activations and weights of one type, f32 sums); the
  tensor's type picks it. The f32 instance keeps f32 accuracy by split
  TF32: every operand is the sum of two TF32 values and three products
  replace one (`split_tf32`, `conv1d_split_tf32_reference`).
- `pack_weight` / `pack_stage` lay a conv's weights out as the kernel
  streams them, `[tap][16-byte slice of C_in][C_out][values of the slice]`,
  zero-padded, for f32 as a (hi, lo) pair of TF32 parts. A caller that
  keeps a stage packs it once (`hifigan.Generator`); `mrf_stage` given raw
  (weight, bias) pairs alone packs on the fly.
- `conv_geometry` gives the kernel's tile sizes, ring depths and
  shared-memory bytes per (C, taps, dilation, type); the CUDA entry point
  re-derives them and refuses a disagreement.
- `mrf_stage_int8` runs the same stage through the int8 convolution of
  `models/quant.py` (Q1, `csrc/int8_mrf_conv.cu`): one conv launch per conv
  (`int8_conv1d.launches`). Every conv's scale is the abs-max that the
  conv writing its input took in its epilogue; the stage input's comes
  from the upsample before it (`x_amax`) or, given none, from one
  activation-scale launch (`row_scale.launches`), and the last conv takes
  the stage output's for the next upsample (`amax_out`). Residual, branch
  scale and accumulation are the conv's epilogue, as in K1.
  `mrf_stage_int8_reference` is its plain version.
- `mrf_stage_op` is the same stage registered as the operator
  `torch.ops.wetts_tpu_torch.mrf_stage` (the launcher on a GPU, the plain
  version on the CPU, a fake for tracing), so that `torch.export` keeps the
  stage as one node and an exported decoder launches K1 on the card
  (`bin/export_graphs.py`); a program that loads such a graph imports this
  module first. The serving path calls `mrf_stage` itself: the operator's
  dispatch and flattening cost the host some 0.9 ms more a B = 1 v1
  decode (four stage calls), 14% of that decode's 6.3 ms of wall time on
  an H100 host (chip_smoke.py's `export` line,
  `op_extra_host_us_per_decode` and `v1_live_decode_wall_ms`).
- `mrf_stage_reference` is the plain PyTorch version, the eager ResBlock
  chain through F.conv1d, and the kernel's oracle on the card. It is also
  the differentiable route: the kernel has no backward (as the TPU kernel
  has no VJP), so `mrf_stage` raises on a CUDA tensor when autograd is
  recording and its input or a weight requires grad, and a caller that
  wants gradients (`hifigan.Generator` in training) calls the plain
  version itself.

The kernel does the stage's whole arithmetic itself (no cuDNN, cuBLAS or
torch.matmul): the leaky relu is fused into its input load, and the bias,
the residual add and the branch mean into its epilogue. By the count of
its work it is bound by arithmetic, so the design is about feeding the
tensor cores: the taps are shifted rows of one shared input tile, weights
stream through a ring of bulk asynchronous copies, producer warps stage the
next chunk of input channels while the consumer warpgroups multiply, two
bf16 blocks share an SM, and the epilogue goes through shared memory so
that global memory sees whole rows. The note at the top of the CUDA source
has the details, and what still holds the kernel back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

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
    row_scale,
)
from wetts_tpu_torch.utils import cuda_build

# one branch: its (weight [C, C, K], bias [C]) pairs in execution order
Branch = Sequence[Tuple[torch.Tensor, torch.Tensor]]

# kernel sizes the wrapper takes (HiFi-GAN's resblocks); the kernel itself
# takes the tap count and the dilation at run time
KERNEL_TAPS = (3, 5, 7, 9, 11)

# ---- the kernel's geometry and weight layout (plain Python and PyTorch) ----

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on an H100
SLICE_BYTES = 16     # one K slice of an operand row: 4 f32 or 8 bf16 values
CHUNK_SLICES = 8     # slices staged together: 64 bf16 or 32 f32 channels
X_STAGES = 2         # at most, of the input ring
BARRIER_BYTES = 96   # the mbarriers behind the rings


class ConvGeometry(NamedTuple):
    """How one conv launch tiles its work: a block's `wgs` consumer
    warpgroups own `mt` 64-row tiles each, `tt` positions in all, by `nt`
    output channels; the input tile has `rows` rows (the taps' halo
    included), stored `rows_p` apart per slice; C_in is padded to `n_slices`
    16-byte slices, C_out to `co_p`; the input ring holds `x_stages` chunks
    of channels, the weight ring `w_stages` tiles of (chunk, `tps` taps);
    f32 keeps `parts` = 2 tiles (TF32 hi and lo) of each."""
    nt: int
    mt: int
    wgs: int
    tt: int
    rows: int
    rows_p: int
    n_slices: int
    co_p: int
    x_stages: int
    w_stages: int
    tps: int
    parts: int
    smem_bytes: int

    def tap_shift_bytes(self, tap: int, dil: int) -> int:
        """What tap `tap` adds to the input operand's start address."""
        return tap * dil * SLICE_BYTES

    def for_kernel(self) -> Tuple[int, ...]:
        return (self.nt, self.mt, self.wgs, self.rows_p, self.n_slices,
                self.co_p, self.x_stages, self.w_stages, self.tps,
                self.smem_bytes)


def _tile(c: int, f32: bool) -> Tuple[int, int, int]:
    """(nt, mt, wgs) for C channels. bf16: 64 channels a block and one
    consumer warpgroup, so that two blocks share an SM and one's loads and
    stores hide behind the other's products. f32 keeps two tiles of
    everything and does three products, which wants the wider tile: 128
    channels, two consumer warpgroups, one block an SM. Narrow stages get
    more rows per block, so that the halo, the weights and the epilogue are
    amortised."""
    if f32:
        nt = 16 if c <= 16 else 32 if c <= 32 else 64 if c <= 64 else 128
        return nt, (4 if nt <= 32 else 128 // nt), 2
    nt = 16 if c <= 16 else 32 if c <= 32 else 64
    return nt, 128 // nt, 1


def _padded_widths(c: int, f32: bool) -> Tuple[int, int, int]:
    """(values per slice, slices of the padded C_in, padded C_out): C_in to
    the instruction's depth of two slices, C_out to the tile."""
    per_slice = SLICE_BYTES // (4 if f32 else 2)
    nt = _tile(c, f32)[0]
    return (per_slice, 2 * -(-c // (2 * per_slice)), -(-c // nt) * nt)


@functools.lru_cache(maxsize=None)
def conv_geometry(c: int, taps: int, dil: int, f32: bool) -> ConvGeometry:
    """The geometry of one launch; ValueError where the halo does not fit
    into shared memory. Two bf16 blocks share an SM where `smem_bytes` is at
    most 115,712 (every conv of the example configs but v3's dilation 12 at
    C = 128)."""
    nt, mt, wgs = _tile(c, f32)
    _, n_slices, co_p = _padded_widths(c, f32)
    parts = 2 if f32 else 1
    tt = wgs * mt * 64
    rows = tt + (taps - 1) * dil
    rows_p = (rows + 6) // 8 * 8 + 1  # 1 (mod 8): slices fall into other banks
    x_stages = min(X_STAGES, -(-n_slices // CHUNK_SLICES))
    w_stages = 3 if f32 else 4
    # taps per weight tile: about 16 KB a tile (f32: 32 KB, but 16 KB at 64
    # channels, where the input ring is at its largest)
    tps = min(taps, max(1, 64 // nt) if f32 and nt >= 32 else 128 // nt)
    chunk_slices = min(CHUNK_SLICES, n_slices)
    rings = (x_stages * parts * chunk_slices * rows_p * SLICE_BYTES
             + w_stages * tps * parts * chunk_slices * nt * SLICE_BYTES)
    # the epilogue's tiles of the output lie over the rings: the residual's
    # and, in bf16, that of the output to accumulate to
    tiles = tt * (nt + 8) * (4 if f32 else 2 * 2)
    smem = max(rings, tiles) + BARRIER_BYTES
    if smem > SMEM_LIMIT:
        raise ValueError(f"an MRF conv of C={c}, {taps} taps, dilation {dil} "
                         f"needs {smem} bytes of shared memory, above "
                         f"{SMEM_LIMIT}")
    return ConvGeometry(nt, mt, wgs, tt, rows, rows_p, n_slices, co_p,
                        x_stages, w_stages, tps, parts, smem)


def round_tf32(v: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero, as `cvt.rna.tf32.f32`), by integer masking."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """v = hi + lo up to 2^-21 |v|, both parts TF32 values."""
    hi = round_tf32(v)
    return hi, round_tf32(v - hi)


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """[C_out, C_in, K] f32 or bf16 -> the kernel's layout
    [K][slice][C_out padded][values of the slice], zeros in the padding: the
    run of one (tap, slice) is contiguous, and a row of it is the 16 bytes
    of one operand row's K slice. f32 gives [2, ...]: the TF32 hi parts,
    then the lo parts."""
    f32 = w.dtype == torch.float32
    co, ci, k = w.shape
    per_slice, n_slices, co_p = _padded_widths(co, f32)
    p = w.new_zeros(k, n_slices * per_slice, co_p)
    p[:, :ci, :co] = w.detach().permute(2, 1, 0)
    p = p.view(k, n_slices, per_slice, co_p).permute(0, 1, 3, 2).contiguous()
    return torch.stack(split_tf32(p)) if f32 else p


def unpack_weight(p: torch.Tensor, c: int) -> torch.Tensor:
    """`pack_weight`'s inverse on one packed tensor (for f32: one part):
    [K][slice][C_out padded][values] -> [c, c, K]."""
    k, n_slices, co_p, per_slice = p.shape
    w = p.permute(0, 1, 3, 2).reshape(k, n_slices * per_slice, co_p)
    return w[:, :c, :c].permute(2, 1, 0).contiguous()


def pack_stage(stage: Sequence[Branch]) -> List[Branch]:
    """A stage's (weight, bias) pairs with every weight packed."""
    return [[(pack_weight(w), b.detach()) for w, b in convs]
            for convs in stage]


def conv1d_split_tf32_reference(x: torch.Tensor, w: torch.Tensor,
                                dilation: int, passes: int = 3
                                ) -> torch.Tensor:
    """The f32 instance's arithmetic in plain PyTorch: x [B, C, T] (already
    activated) and w [C_out, C_in, K] are split into TF32 parts, and the
    conv is the sum of the products hi*lo + lo*hi + hi*hi taken in f32
    (`passes` = 1 keeps hi*hi alone: a single TF32 pass)."""
    pad = (w.shape[2] - 1) * dilation // 2
    (xh, xl), (wh, wl) = split_tf32(x), split_tf32(w)
    out = None
    for a, b in (((xh, wl), (xl, wh), (xh, wh)) if passes == 3
                 else ((xh, wh),)):
        y = F.conv1d(a, b, padding=pad, dilation=dilation)
        out = y if out is None else out + y
    return out


def convs_per_branch(resblock_kind: str, dilations: Sequence[int]) -> int:
    return len(dilations) * (2 if resblock_kind == "1" else 1)


def check_stage(stage: Sequence[Branch], resblock_kind: str,
                kernel_sizes: Sequence[int],
                dilations: Sequence[Sequence[int]]) -> None:
    """Raise ValueError unless `stage` fits the topology: per branch j, one
    (weight [C, C, K_j], bias [C]) pair per conv, all on one device, and
    contiguous and all f32 or all bf16 where that device is a GPU (the
    kernel reads them by pointer). A caller that keeps a stage checks it
    once, when it is built, and passes `checked=True` to `mrf_stage`."""
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
                       + [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _geometry_ints(c: int, taps: int, dil: int, f32: bool):
    """`conv_geometry` as the C entry point takes it."""
    ints = conv_geometry(c, taps, dil, f32).for_kernel()
    return (ctypes.c_int * len(ints))(*ints)


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
              checked: bool = False,
              packed: Optional[Sequence[Branch]] = None) -> torch.Tensor:
    """One MRF stage, h [B, T, C] -> [B, T, C].

    stage[j]: branch j's (weight [C, C, K_j], bias [C]) pairs in execution
    order (ResBlock1: conv1_0, conv2_0, conv1_1, ...; ResBlock2: conv_0, ...),
    with weight norm already folded. `checked=True` says the caller has
    passed `stage` through `check_stage` since its weights last changed
    place or type; otherwise it is checked here. `packed` is
    `pack_stage(stage)` where the caller keeps it (it must be packed anew
    whenever the weights change); without it a CUDA call packs on the fly.
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
    if h.numel() == 0:
        return torch.empty_like(h)
    if packed is None:
        packed = pack_stage(stage)
    launch = _launcher(h)
    scale = 1.0 / len(stage)

    def conv(src, wb, k, d, res, dst, mode):
        launch(src, wb[0], wb[1], k, d, res, dst, mode, scale)

    return _run_stage(h, packed, resblock_kind, kernel_sizes, dilations, conv)


def _launcher(h: torch.Tensor) -> Callable:
    """`launch(src, wp, bias, taps, dil, res, dst, mode, scale)` for tensors
    of h's shape, type and device on the current stream: one launch of the
    kernel, counted in `mrf_stage.launches`; raises if it is refused."""
    b, t, c = h.shape
    lib = _library()
    f32 = h.dtype == torch.float32
    fn = lib.mrf_conv_f32 if f32 else lib.mrf_conv_bf16
    stream = torch.cuda.current_stream(h.device).cuda_stream

    def launch(src, wp, bias, taps, dil, res, dst, mode, scale):
        err = fn(src.data_ptr(), wp.data_ptr(), bias.data_ptr(),
                 None if res is None else res.data_ptr(), dst.data_ptr(),
                 b, t, c, taps, dil, LRELU_SLOPE, scale, mode,
                 _geometry_ints(c, taps, dil, f32), stream)
        if err != 0:
            raise RuntimeError(f"mrf_conv launch failed: CUDA error {err}")
        mrf_stage.launches += 1

    return launch


def mrf_conv_reference(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       dilation: int = 1,
                       residual: Optional[torch.Tensor] = None,
                       out: Optional[torch.Tensor] = None, mode: int = STORE,
                       scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of one launch: x [B, T, C] ->
    `out (op)= scale * (conv(lrelu(x)) + bias + residual)`, with `op` by
    `mode` (STORE ignores `scale`, ACCUMULATE_SCALED adds to `out`)."""
    v = F.conv1d(F.leaky_relu(x.transpose(1, 2), LRELU_SLOPE), w, bias,
                 padding=get_padding(w.shape[2], dilation),
                 dilation=dilation).transpose(1, 2)
    if residual is not None:
        v = v + residual
    if mode == STORE:
        return v
    return v * scale if mode == STORE_SCALED else out + v * scale


def mrf_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             dilation: int = 1, residual: Optional[torch.Tensor] = None,
             out: Optional[torch.Tensor] = None, mode: int = STORE,
             scale: float = 1.0) -> torch.Tensor:
    """One conv of a stage by itself, x [B, T, C] f32 or bf16 with w
    [C, C, K] and bias [C] of the same type: one launch of K1 on a CUDA
    tensor (the weights packed on the fly), the plain version on a CPU
    tensor. `out` may be `residual` (ResBlock1's in-place sum) and must be
    given for ACCUMULATE_SCALED; it must not be `x`."""
    if mode not in (STORE, STORE_SCALED, ACCUMULATE_SCALED):
        raise ValueError(f"mode must be 0, 1 or 2, got {mode}")
    if mode == ACCUMULATE_SCALED and out is None:
        raise ValueError("ACCUMULATE_SCALED adds to `out`")
    check_stage([[(w, bias)]], "2", (w.shape[2],), ((dilation,),))
    c = x.shape[2]
    for name, other in (("residual", residual), ("out", out)):
        if other is not None and (other.shape != x.shape
                                  or other.dtype != x.dtype
                                  or other.device != x.device):
            raise ValueError(f"`{name}` does not fit x")
    if w.shape[0] != c or w.device != x.device:
        raise ValueError(f"weights of C={w.shape[0]} on {w.device} do not "
                         f"fit x of C={c} on {x.device}")
    if x.device.type == "cpu":
        v = mrf_conv_reference(x, w, bias, dilation, residual, out, mode,
                               scale)
        return v if out is None else out.copy_(v)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_conv runs on cuda or cpu, not {x.device}")
    if (x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype
            or c % 4 != 0 or w.shape[2] not in KERNEL_TAPS):
        raise ValueError(f"the MRF kernel takes f32 or bf16 with weights of "
                         f"the same type, C % 4 == 0 and kernel sizes in "
                         f"{KERNEL_TAPS}")
    _refuse_gradient(x, (w, bias), "the MRF kernel")
    if out is None:
        out = torch.empty_like(x)
    if (not x.is_contiguous() or not out.is_contiguous()
            or out.data_ptr() == x.data_ptr()
            or (residual is not None and not residual.is_contiguous())):
        raise ValueError("x, residual and out must be contiguous, and out "
                         "must not be x")
    if x.numel():
        _launcher(x)(x, pack_weight(w), bias, w.shape[2], dilation, residual,
                     out, mode, scale)
    return out


mrf_stage.launches = 0


# ---- the stage as a registered operator, for graphs that torch.export takes ----


def _nested_stage(weights: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor],
                  kernel_sizes: Sequence[int], dilations: Sequence[int],
                  dilation_counts: Sequence[int], resblock_kind: str
                  ) -> Tuple[List[Branch], List[List[int]]]:
    """The op's flat arguments back as (stage, per-branch dilations)."""
    stage, dils, i, j = [], [], 0, 0
    for n in dilation_counts:
        dils.append(list(dilations[j:j + n]))
        j += n
        m = convs_per_branch(resblock_kind, dils[-1])
        stage.append(list(zip(weights[i:i + m], biases[i:i + m])))
        i += m
    return stage, dils


@torch.library.custom_op("wetts_tpu_torch::mrf_stage", mutates_args=(),
                         device_types="cpu")
def mrf_stage_op(h: torch.Tensor, weights: List[torch.Tensor],
                 biases: List[torch.Tensor], packed: List[torch.Tensor],
                 resblock_kind: str, kernel_sizes: List[int],
                 dilations: List[int], dilation_counts: List[int]
                 ) -> torch.Tensor:
    """`mrf_stage` as the operator `torch.ops.wetts_tpu_torch.mrf_stage`,
    which `torch.export` keeps as one node of a graph (the launcher reads
    raw pointers, which a traced tensor has none of). The stage is flat:
    its convs' folded weights and biases in execution order, `packed` their
    `pack_weight` layouts (K1's, on a GPU; may be empty), the dilations of
    every branch one after another with their counts per branch. On the
    CPU it is the plain version; on a GPU the launcher (counted in
    `mrf_stage.launches`); a fake tensor gets the shape of h."""
    stage, dils = _nested_stage(weights, biases, kernel_sizes, dilations,
                                dilation_counts, resblock_kind)
    return mrf_stage_reference(h, stage, resblock_kind, kernel_sizes,
                               dils).contiguous()


@mrf_stage_op.register_kernel("cuda")
def _mrf_stage_op_cuda(h, weights, biases, packed, resblock_kind,
                       kernel_sizes, dilations, dilation_counts):
    stage, dils = _nested_stage(weights, biases, kernel_sizes, dilations,
                                dilation_counts, resblock_kind)
    pk = None
    if packed:
        pk = _nested_stage(packed, biases, kernel_sizes, dilations,
                           dilation_counts, resblock_kind)[0]
    return mrf_stage(h, stage, resblock_kind, kernel_sizes, dils,
                     packed=pk)


@mrf_stage_op.register_fake
def _mrf_stage_op_fake(h, weights, biases, packed, resblock_kind,
                       kernel_sizes, dilations, dilation_counts):
    return torch.empty_like(h)


def mrf_stage_as_op(h: torch.Tensor, stage: Sequence[Branch],
                    resblock_kind: str, kernel_sizes: Sequence[int],
                    dilations: Sequence[Sequence[int]],
                    packed: Optional[Sequence[Branch]] = None
                    ) -> torch.Tensor:
    """`mrf_stage(h, stage, ..., packed=packed)` through `mrf_stage_op`."""
    convs = [wb for branch in stage for wb in branch]
    return mrf_stage_op(
        h, [w for w, _ in convs], [b for _, b in convs],
        [w for branch in packed or () for w, _ in branch], resblock_kind,
        list(kernel_sizes), [d for ds in dilations for d in ds],
        [len(ds) for ds in dilations])


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
                   dilations: Sequence[Sequence[int]],
                   x_amax: Optional[torch.Tensor] = None,
                   amax_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One MRF stage with int8 convolutions, h [B, T, C] f32 or bf16 ->
    [B, T, C]. The scale of h, shared by the branches' first convs, is
    finished from `x_amax` (the abs-max of lrelu(h) per row that the
    upsample before took) where given, else one `row_scale` of h. Each
    conv that stores an input of a later conv takes that input's abs-max
    per row into a row of one zeroed `[n_convs, B]` buffer, from which the
    later conv finishes its scale; the last conv, which stores the stage's
    output, takes its abs-max into `amax_out` ([B] f32, zeroed by the
    caller) where given, the next upsample's `x_amax`. On a CUDA tensor
    every conv is one `int8_conv1d` launch (counted there); on a CPU tensor
    the same plumbing runs the plain versions, and the result equals
    `mrf_stage_int8_reference`."""
    if resblock_kind not in ("1", "2"):
        raise ValueError(f"resblock must be '1' or '2', got {resblock_kind!r}")
    if len(stage) != len(dilations) or any(
            len(convs) != convs_per_branch(resblock_kind, d)
            for convs, d in zip(stage, dilations)):
        raise ValueError("the int8 stage does not fit the topology")
    _refuse_gradient(h, (), "the int8 MRF stage")
    h = h.contiguous()
    scale = 1.0 / len(stage)
    n_convs = sum(len(convs) for convs in stage)
    amax = torch.zeros(n_convs, h.shape[0], device=h.device,
                       dtype=torch.float32)
    rows = iter(amax)
    # where the scale of each buffer's current contents comes from: (sx,
    # None), a finished scale, or (None, x_amax), an abs-max to finish
    scale_of = {id(h): (None, x_amax) if x_amax is not None
                else (row_scale(h, LRELU_SLOPE), None)}
    remaining = n_convs

    def conv(src, qconv, k, d, res, dst, mode):
        nonlocal remaining
        sx, x_amax = scale_of[id(src)]
        remaining -= 1
        if mode == STORE:
            out_amax = next(rows)
        else:  # the output; the last conv stores its final values
            out_amax = amax_out if remaining == 0 else None
        int8_conv1d(src, qconv, d, LRELU_SLOPE, residual=res, out=dst,
                    mode=mode, branch_scale=scale, sx=sx, x_amax=x_amax,
                    amax_out=out_amax)
        if mode == STORE:
            scale_of[id(dst)] = (None, out_amax)

    return _run_stage(h, stage, resblock_kind,
                      [convs[0].taps for convs in stage], dilations, conv)
