"""int8 convolutions with dynamic activation scales (port of the `q8` path of
wetts_tpu/models/hifigan_fast.py:115-176).

The rule, as the JAX package computes it:

- weights: symmetric int8 per output channel over taps and input channels,
  `sw[co] = max(max|w[.., co]|, 1e-12) / 127`, `wq = clip(round(w / sw),
  -127, 127)`, from the folded f32 kernel. A transposed conv that the JAX
  package runs in its blocked layout carries one scale per (output phase
  `t mod u`, output channel) instead: column `(io, co)` of its blocked kernel
  holds only the taps `j = io + pd (mod u)`. `upsample_scale_per_phase`
  says, as `fast_generator_apply` decides it, which upsamples those are;
- activations: one scale per batch row over the whole `(T, C)` of the conv's
  input after its leaky relu, `sx[b] = max(max|x[b]|, 1e-12) / 127` in f32,
  `xq = clip(round(f32(x) / sx), -127, 127)` (a division, round half to
  even);
- int8 x int8 products with int32 sums;
- `y = (f32(acc) * (sx[b] * sw[co])).to(x.dtype)`, then the bias is added in
  `x.dtype`.

Activations are `[B, T, C]` (channels last, as kernel K1 takes them), f32 or
bf16. Quantised weights are made once (`QuantConv1d`, `QuantConvTranspose1d`)
and never per call, and kept packed as the wgmma kernel streams them
(`pack_int8_weight`, tiled as `int8_conv_geometry` and
`int8_upsample_geometry` say).

- `row_scale`, `int8_conv1d` and `int8_conv_transpose1d` are the wrappers: on
  a CUDA tensor each launches its hand-written kernel (`row_scale` in
  `csrc/int8_conv.cu`, the stride-1 conv and the transposed conv, one GEMM
  kernel, in `csrc/int8_mrf_conv.cu`) and counts the launch (`.launches`);
  on a CPU tensor each runs its plain version. None falls back from its
  kernel.
- `int8_conv1d` and `int8_conv_transpose1d` take their input's scale as
  given (`sx`), as the abs-max a conv before them gathered (`x_amax`), or,
  given neither, from one `row_scale` launch; with `amax_out` they take the
  max of `|lrelu(out)|` over what they store per batch row into that
  buffer, so that the conv that reads their output needs no pass of its own
  (`mrf.mrf_stage_int8`, `hifigan.Generator`'s int8 route). A max does not
  depend on order, so the scales are bit-equal to `row_scale`'s either way.
- `row_scale_reference`, `int8_conv1d_reference` and
  `int8_conv_transpose1d_reference` are the plain PyTorch versions. They
  take the integer sums exactly, through a float64 convolution of the
  quantised integers (an int32 convolution does not run on CUDA, and f32
  cannot hold sums of up to 127 * 127 * C * k), so kernel and plain version
  differ only by the rounding of the output type.

The kernels replace `lax.conv_general_dilated` on int8 operands
(hifigan_fast.py:147-151); what bounds them and how their design answers
that is in the note at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from wetts_tpu_torch.utils import cuda_build

# the JAX package's lane width: its decoder enters the blocked layout, and
# with it the per-phase upsample scales, where a stage has fewer channels
LANES = 128
STORE, STORE_SCALED, ACCUMULATE_SCALED = 0, 1, 2

# ---- Q1's geometry and weight layout (csrc/int8_mrf_conv.cu) ----

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on an H100
TWO_BLOCKS = 115712  # at most this, two blocks share an SM
SLICE = 16           # int8 values of one 16-byte K slice of an operand row
CHUNK_SLICES = 8     # slices staged together: 128 input channels
X_STAGES, W_STAGES = 2, 4
MAX_X_STAGES = 4     # the input ring's most stages
BARRIER_BYTES = 128  # the mbarriers behind the rings
COLUMN_BYTES = 1024  # a pass's 128 column scales and biases (f32)


class Q8Geometry(NamedTuple):
    """How one launch of Q1 tiles its work: a tile is `mt` 64-row wgmma
    tiles (`mt * 64` positions) by `nt` output channels, and a block's
    consumer warpgroup works through tiles in turn; the input tile has
    `rows_p` rows (the taps' halo and padding to 1 mod 8) per 16-byte slice
    of C_in (`n_slices`); C_out is padded to `co_p`; the input ring holds
    `x_stages` chunks of 128 channels, the weight ring `w_stages` tiles of
    (chunk, `tps` taps); the epilogue's tiles lie beside the rings."""
    nt: int
    mt: int
    rows_p: int
    n_slices: int
    co_p: int
    x_stages: int
    w_stages: int
    tps: int
    smem_bytes: int


def _q8_tile(c_out: int) -> int:
    return (16 if c_out <= 16 else 32 if c_out <= 32 else 64 if c_out <= 64
            else 128)


@functools.lru_cache(maxsize=None)
def int8_conv_geometry(c_in: int, c_out: int, taps: int, dil: int,
                       f32: bool) -> Q8Geometry:
    """Q1's geometry for one conv (`f32`: the activations' type); the CUDA
    entry point re-derives it and refuses a disagreement. ValueError where
    the shapes do not fit the kernel."""
    if c_in % 32 or c_out % 8 or taps % 2 == 0 or dil < 1:
        raise ValueError(f"the int8 conv takes C_in % 32 == 0, C_out % 8 == "
                         f"0 and an odd kernel size; got {c_in} -> {c_out}, "
                         f"k={taps}, dilation {dil}")
    return _gemm_geometry(c_in, c_out, taps, dil, f32, 2, False)


@functools.lru_cache(maxsize=None)
def int8_upsample_geometry(c_in: int, c_out: int, k: int, u: int,
                           f32: bool) -> Q8Geometry:
    """Q2's geometry for one upsample (transposed conv of kernel size k,
    stride u): the same kernel's GEMM with N = u * C_out columns (phase x
    output channel) and K = ceil(k / u) taps of C_in, dilation 1, and one
    epilogue tile (no residual); its input ring holds a whole tile, so that
    a block can take several N tiles with the input staged once. ValueError
    where it does not fit."""
    if c_in % 32 or c_out % 8 or k < 1 or u < 1:
        raise ValueError(f"the int8 upsample takes C_in % 32 == 0 and C_out "
                         f"% 8 == 0; got {c_in} -> {c_out}, k={k}, u={u}")
    return _gemm_geometry(c_in, u * c_out, -(-k // u), 1, f32, 1, True)


def _gemm_geometry(c_in: int, c_out: int, taps: int, dil: int, f32: bool,
                   epi_tiles: int, hold_input: bool) -> Q8Geometry:
    """The tiling of one launch of the GEMM kernel: `c_out` columns, `taps`
    shifted input rows `dil` apart, `epi_tiles` epilogue tiles (the
    residual's and the output's, or the output's alone); with `hold_input`
    the input ring holds every chunk of a tile (up to MAX_X_STAGES)."""
    nt = _q8_tile(c_out)
    mt = 1 if nt == 128 else 128 // nt
    rows = mt * 64 + (taps - 1) * dil
    rows_p = (rows + 6) // 8 * 8 + 1  # 1 (mod 8): slices fall into other banks
    n_slices = c_in // SLICE
    co_p = -(-c_out // nt) * nt
    chunk = min(CHUNK_SLICES, n_slices)
    # two input stages even for one chunk: the next tile's comes in while
    # the consumers work on this one's
    n_chunks = -(-n_slices // CHUNK_SLICES)
    x_stages = (n_chunks if hold_input and X_STAGES < n_chunks
                <= MAX_X_STAGES else X_STAGES)
    tps = min(taps, 1 if nt == 128 else 128 // nt)
    x_ring = x_stages * chunk * rows_p * 16
    w_tile = tps * chunk * nt * 16
    # the epilogue's tiles, and a pass's column scales and biases
    tiles = mt * 64 * (nt + 8) * (4 if f32 else 2) * epi_tiles + COLUMN_BYTES

    def smem_of(w_stages):
        return x_ring + w_stages * w_tile + tiles + BARRIER_BYTES

    # a shallower weight ring keeps two blocks an SM: 4 stages, else (for a
    # held input) 3, else 2
    w_stages = W_STAGES
    if smem_of(w_stages) > TWO_BLOCKS and hold_input:
        w_stages = 3
    if smem_of(w_stages) > TWO_BLOCKS:
        w_stages = 2
    smem = smem_of(w_stages)
    if smem > SMEM_LIMIT:
        raise ValueError(f"an int8 conv of C={c_in} -> {c_out}, {taps} taps, "
                         f"dilation {dil} needs {smem} bytes of shared "
                         f"memory, above {SMEM_LIMIT}")
    return Q8Geometry(nt, mt, rows_p, n_slices, co_p, x_stages, w_stages, tps,
                      smem)


def pack_int8_weight(wq: torch.Tensor) -> torch.Tensor:
    """int8 `[C_out, C_in, K]` -> Q1's layout `[K][C_in / 16][C_out padded
    to the tile][16]`, zeros in the padding (C_in to 16, C_out to the
    tile): the run of one (tap, slice) is contiguous, and a row of it is the
    16 bytes of one operand row's K slice, as the kernel's bulk copies and
    wgmma take them."""
    co, ci, k = wq.shape
    ci_p = -(-ci // SLICE) * SLICE
    co_p = -(-co // _q8_tile(co)) * _q8_tile(co)
    p = wq.new_zeros(k, ci_p, co_p)
    p[:, :ci, :co] = wq.permute(2, 1, 0)
    return p.view(k, ci_p // SLICE, SLICE, co_p).permute(0, 1, 3,
                                                          2).contiguous()


def unpack_int8_weight(p: torch.Tensor, c_out: int, c_in: int
                       ) -> torch.Tensor:
    """`pack_int8_weight`'s inverse: -> `[c_out, c_in, K]`."""
    k, n_slices, co_p, _ = p.shape
    w = p.permute(0, 1, 3, 2).reshape(k, n_slices * SLICE, co_p)
    return w[:, :c_in, :c_out].permute(2, 1, 0).contiguous()


def upsample_scale_per_phase(upsample_initial_channel: int,
                             upsample_rates: Sequence[int],
                             t_in: int) -> List[bool]:
    """For each upsample stage, whether the JAX package quantises its
    weights per (output phase, output channel) rather than per output
    channel: true where `fast_generator_apply` (hifigan_fast.py:259-287)
    runs that transposed conv as a blocked kernel, which it decides from the
    stage's channels, its rate, the input length and the blocking so far."""
    r, t, out = 1, t_in, []
    for i, u in enumerate(upsample_rates):
        ch = upsample_initial_channel // 2 ** (i + 1)
        if r > 1:
            out.append(True)
            r *= u
        elif ch < LANES and LANES % ch == 0 and (
                u == LANES // ch or (t * u) % (LANES // ch) == 0):
            out.append(u == LANES // ch)
            r = LANES // ch
        else:
            out.append(False)
        t *= u
    return out


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 in f32, as a true division: by a tensor,
    because PyTorch on CUDA multiplies by the reciprocal of a Python scalar,
    which rounds differently."""
    amax = torch.clamp_min(amax.float(), 1e-12)
    return amax / torch.full_like(amax, 127.0)


def _quantize(w: torch.Tensor, amax: torch.Tensor):
    scale = _scale_of(amax)
    wq = torch.clamp(torch.round(w.float() / scale), -127, 127)
    return wq.to(torch.int8), scale


def quantize_weight(w: torch.Tensor, stride: Optional[int] = None,
                    padding: int = 0, per_phase: bool = False):
    """Folded f32 kernel -> (int8 kernel of the same shape, f32 scale).

    `stride=None`: a conv kernel `[O, I, K]`, scale `[O]`. With `stride` u:
    a transposed-conv kernel `[I, O, K]`, scale `[u, O]` indexed by the
    output phase `t mod u`; with `per_phase` each phase's scale covers only
    the taps `j = t + padding (mod u)` that reach it, otherwise every row
    is the per-output-channel scale over all taps."""
    if stride is None:
        wq, scale = _quantize(w, w.abs().amax(dim=(1, 2))[:, None, None])
        return wq, scale[:, 0, 0]
    k = w.shape[2]
    if per_phase:
        tap_phase = (torch.arange(k, device=w.device) - padding) % stride
        amax = torch.stack([
            w[:, :, tap_phase == p].abs().amax(dim=(0, 2))
            if bool((tap_phase == p).any()) else w.new_zeros(w.shape[1])
            for p in range(stride)])                       # [u, O]
        wq, _ = _quantize(w, amax[tap_phase].t()[None])    # [1, O, K]
        return wq, _scale_of(amax)
    wq, scale = _quantize(w, w.abs().amax(dim=(0, 2))[None, :, None])
    return wq, scale[0, :, 0].expand(stride, -1).contiguous()


class QuantConv1d:
    """A stride-1 'same' conv's quantised kernel: `wq` int8 `[O, I, K]`,
    `scale` f32 `[O]`, `bias` `[O]` in the compute dtype or None, and
    `packed`, Q1's layout (`pack_int8_weight`)."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 dtype: torch.dtype = torch.float32):
        self.wq, self.scale = quantize_weight(weight)
        self.bias = None if bias is None else bias.detach().to(dtype)
        self.out_channels, self.in_channels, self.taps = weight.shape
        self.packed = pack_int8_weight(self.wq)


class QuantConvTranspose1d:
    """A transposed conv's quantised kernel: `wq` int8 `[I, O, K]`, `scale`
    f32 `[u, O]` by output phase. For the kernel (Q2), the upsample is one
    GEMM whose column `p * O + co` is output phase `p` of position m (row
    `m * u + p - padding`) and channel co: `gemm_weight()` is that GEMM's
    `[u * O, I, n]` kernel, n = ceil(K / u) taps over the input rows `m -
    (n - 1) .. m`, its tap i and phase p holding `wq[:, co, p + u * (n - 1
    - i)]` (zero past K); `packed` is it in Q1's layout
    (`pack_int8_weight`), made once; `packed_scale` `[u, O]` and
    `packed_bias` `[u * O]` (or None) are each column's scale, that of the
    output phase `(p - padding) mod u` those taps write, and bias."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 stride: int, padding: int, per_phase: bool,
                 dtype: torch.dtype = torch.float32):
        self.stride, self.padding = stride, padding
        self.wq, self.scale = quantize_weight(weight, stride, padding,
                                              per_phase)
        self.bias = None if bias is None else bias.detach().to(dtype)
        self.in_channels, self.out_channels, self.taps = weight.shape
        self.taps_per_phase = -(-self.taps // stride)
        self.packed = pack_int8_weight(self.gemm_weight())
        phases = (torch.arange(stride, device=weight.device)
                  - padding) % stride
        self.packed_scale = self.scale[phases].contiguous()
        self.packed_bias = (None if self.bias is None
                            else self.bias.repeat(stride))

    def gemm_weight(self) -> torch.Tensor:
        """int8 `[u * O, I, n]`: row `p * O + co`, tap i is `wq[:, co, p +
        u * (n - 1 - i)]`."""
        n, u = self.taps_per_phase, self.stride
        padded = F.pad(self.wq, (0, n * u - self.taps))
        # [I, O, n (s), u (p)] -> [u, O, I, n reversed: tap i = n - 1 - s]
        return padded.reshape(self.in_channels, self.out_channels, n,
                              u).flip(2).permute(3, 1, 0, 2).reshape(
                                  u * self.out_channels, self.in_channels, n)

    def out_length(self, t_in: int) -> int:
        return (t_in - 1) * self.stride - 2 * self.padding + self.taps


def _lrelu(x: torch.Tensor, slope: Optional[float]) -> torch.Tensor:
    return x if slope is None else F.leaky_relu(x, slope)


def row_scale_reference(x: torch.Tensor, slope: Optional[float] = None
                        ) -> torch.Tensor:
    """`sx[b] = max(max|lrelu(x[b])|, 1e-12) / 127`, f32 `[B]`."""
    return _scale_of(_lrelu(x, slope).abs().amax(dim=(1, 2)))


def _quantize_rows(x, slope, sx):
    xt = _lrelu(x, slope).float()
    return torch.clamp(torch.round(xt / sx[:, None, None]), -127, 127)


def int8_conv1d_reference(x: torch.Tensor, conv: QuantConv1d,
                          dilation: int = 1, slope: Optional[float] = None,
                          sx: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain version: `x [B, T, C_in]` -> `[B, T, C_out]` in `x.dtype`, with
    the activation scale `sx` (default `row_scale_reference(x, slope)`)."""
    if sx is None:
        sx = row_scale_reference(x, slope)
    xq = _quantize_rows(x, slope, sx)
    acc = F.conv1d(xq.double().transpose(1, 2), conv.wq.double(),
                   padding=(conv.taps - 1) * dilation // 2,
                   dilation=dilation).transpose(1, 2)
    y = (acc.float() * (sx[:, None, None] * conv.scale)).to(x.dtype)
    return y if conv.bias is None else y + conv.bias


def int8_conv_transpose1d_reference(x: torch.Tensor,
                                    conv: QuantConvTranspose1d,
                                    slope: Optional[float] = None,
                                    sx: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """Plain version: `x [B, T, C_in]` -> `[B, T_out, C_out]`, with the
    activation scale `sx` (default `row_scale_reference(x, slope)`)."""
    if sx is None:
        sx = row_scale_reference(x, slope)
    xq = _quantize_rows(x, slope, sx)
    acc = F.conv_transpose1d(xq.double().transpose(1, 2), conv.wq.double(),
                             stride=conv.stride, padding=conv.padding
                             ).transpose(1, 2)
    phase = torch.arange(acc.shape[1], device=x.device) % conv.stride
    y = (acc.float() * (sx[:, None, None] * conv.scale[phase])).to(x.dtype)
    return y if conv.bias is None else y + conv.bias


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("int8_conv")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.int8_row_scale.argtypes = [ptr, ptr, ptr, i32, ptr, i32,
                                   ctypes.c_longlong, f32, i32, ptr]
    lib.int8_row_scale.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _conv_library() -> ctypes.CDLL:
    lib = cuda_build.load("int8_mrf_conv")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    geometry = ctypes.POINTER(ctypes.c_int)
    lib.int8_mrf_conv.argtypes = ([ptr, ptr, i32] + [ptr] * 6 + [i32] * 6
                                  + [f32, f32, i32, i32, geometry, ptr])
    lib.int8_conv_transpose1d.argtypes = ([ptr, ptr, i32] + [ptr] * 5
                                          + [i32] * 8 + [f32, i32, geometry,
                                                         ptr])
    for fn in (lib.int8_mrf_conv, lib.int8_conv_transpose1d):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _geometry_ints(c_in: int, c_out: int, taps: int, dil: int, f32: bool):
    """`int8_conv_geometry` as the C entry point takes it."""
    ints = int8_conv_geometry(c_in, c_out, taps, dil, f32)
    return (ctypes.c_int * len(ints))(*ints)


@functools.lru_cache(maxsize=None)
def _upsample_geometry_ints(c_in: int, c_out: int, k: int, u: int,
                            f32: bool):
    """`int8_upsample_geometry` as the C entry point takes it."""
    ints = int8_upsample_geometry(c_in, c_out, k, u, f32)
    return (ctypes.c_int * len(ints))(*ints)


def _check_cuda_input(x: torch.Tensor, conv, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes f32 or bf16, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous [B, T, C] tensor")
    if conv is None:
        return
    if x.shape[2] != conv.in_channels or conv.in_channels % 32 \
            or conv.out_channels % 8:
        raise ValueError(
            f"{name}: the kernel takes C_in % 32 == 0 and C_out % 8 == 0 "
            f"and a kernel that fits x; got x of C={x.shape[2]}, kernel "
            f"{conv.in_channels} -> {conv.out_channels}")
    if conv.packed.device != x.device or (
            conv.bias is not None and conv.bias.dtype != x.dtype):
        raise ValueError(f"{name}: the quantised kernel lies on "
                         f"{conv.packed.device} with another bias type "
                         f"than x ({x.dtype} on {x.device})")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(f"{name} has no backward: run it under "
                           "torch.no_grad()")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# Q0's ticket counters, one per (device, stream): zeroed once when made, and
# zero again at the end of every launch (csrc/int8_conv.cu)
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
ROW_SCALE_BLOCKS = 128  # Q0's most blocks per row, its scratch per row


def row_scale(x: torch.Tensor, slope: Optional[float] = None
              ) -> torch.Tensor:
    """Activation scales of `x [B, T, C]` after its leaky relu, f32 `[B]`,
    computed on the device in one launch, without a host sync."""
    if x.device.type == "cpu":
        return row_scale_reference(x, slope)
    _check_cuda_input(x, None, "row_scale")
    n = x.shape[1] * x.shape[2]
    if n % 4:
        raise ValueError("row_scale: T * C must be a multiple of 4")
    stream = _stream(x)
    key = (x.device.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, device=x.device, dtype=torch.int32)
    sx = torch.empty(x.shape[0], device=x.device, dtype=torch.float32)
    partial = torch.empty(x.shape[0] * ROW_SCALE_BLOCKS, device=x.device,
                          dtype=torch.float32)
    err = _library().int8_row_scale(
        x.data_ptr(), sx.data_ptr(), partial.data_ptr(), ROW_SCALE_BLOCKS,
        _TICKETS[key].data_ptr(), x.shape[0], n,
        1.0 if slope is None else slope, int(x.dtype == torch.bfloat16),
        stream)
    if err != 0:
        raise RuntimeError(f"int8_row_scale launch failed: CUDA error {err}")
    row_scale.launches += 1
    return sx


row_scale.launches = 0


def _take_amax(v: torch.Tensor, slope: Optional[float],
               amax_out: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain version of an epilogue's abs-max: `amax_out = max(amax_out,
    max |lrelu(v)| per row)`; returns v."""
    if amax_out is not None:
        torch.maximum(amax_out,
                      _lrelu(v, slope).abs().amax(dim=(1, 2)).float(),
                      out=amax_out)
    return v


def _input_scale(x: torch.Tensor, slope: Optional[float],
                 sx: Optional[torch.Tensor], x_amax: Optional[torch.Tensor],
                 amax_out: Optional[torch.Tensor], name: str):
    """For a kernel launch on `x`: (whether the scale is finished, the [B]
    buffer to pass): `sx` where given, else the abs-max `x_amax` for the
    kernel to finish, else one `row_scale` launch."""
    for arg, other in (("sx", sx), ("x_amax", x_amax),
                       ("amax_out", amax_out)):
        if other is not None and not (
                other.shape == (x.shape[0],) and other.dtype == torch.float32
                and other.device == x.device and other.is_contiguous()):
            raise ValueError(f"{name}: `{arg}` must be f32 [B] on "
                             f"{x.device}")
    if x_amax is not None:
        return False, x_amax
    return True, row_scale(x, slope) if sx is None else sx


def _store(v: torch.Tensor, out: Optional[torch.Tensor], mode: int
           ) -> torch.Tensor:
    if out is None:
        return v
    return out.add_(v) if mode == ACCUMULATE_SCALED else out.copy_(v)


def int8_conv1d(x: torch.Tensor, conv: QuantConv1d, dilation: int = 1,
                slope: Optional[float] = None,
                residual: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None, mode: int = STORE,
                branch_scale: float = 1.0, sx: Optional[torch.Tensor] = None,
                x_amax: Optional[torch.Tensor] = None,
                amax_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dilated stride-1 'same' int8 conv of `lrelu(x)`, `x [B, T, C_in]` ->
    `[B, T, C_out]` in `x.dtype`.

    v = conv + bias (+ `residual`), each step rounded to `x.dtype`; then by
    `mode` (kernel K1's store modes): STORE `out = v`, STORE_SCALED `out =
    branch_scale * v`, ACCUMULATE_SCALED `out += branch_scale * v`. `out`
    may be `residual` (each element is read and written by one thread) but
    not `x`. The input's activation scale is `sx` ([B] f32) where given,
    else `max(x_amax, 1e-12) / 127` where the abs-max of `lrelu(x)` per row
    is given, else one `row_scale` launch finds it. `amax_out` ([B] f32,
    zeroed by the caller) takes the max of `|lrelu(out)|` over the stored
    values per row. One conv launch."""
    if sx is not None and x_amax is not None:
        raise ValueError("int8_conv1d takes `sx` or `x_amax`, not both")
    if x.device.type == "cpu":
        if x_amax is not None:
            sx = _scale_of(x_amax)
        v = int8_conv1d_reference(x, conv, dilation, slope, sx)
        if residual is not None:
            v = v + residual
        if mode != STORE:
            v = v * branch_scale
        return _take_amax(_store(v, out, mode), slope, amax_out)
    _check_cuda_input(x, conv, "int8_conv1d")
    b, t, _ = x.shape
    geometry = _geometry_ints(conv.in_channels, conv.out_channels, conv.taps,
                              dilation, x.dtype == torch.float32)
    if out is None:
        if mode == ACCUMULATE_SCALED:
            raise ValueError("ACCUMULATE_SCALED needs `out`")
        out = torch.empty(b, t, conv.out_channels, device=x.device,
                          dtype=x.dtype)
    for name, other in (("residual", residual), ("out", out)):
        if other is not None and not (
                other.shape == (b, t, conv.out_channels)
                and other.dtype == x.dtype and other.device == x.device
                and other.is_contiguous()):
            raise ValueError(f"int8_conv1d: `{name}` does not fit the output")
    if out.data_ptr() == x.data_ptr():
        raise ValueError("int8_conv1d cannot write its own input")
    finished, sx = _input_scale(x, slope, sx, x_amax, amax_out,
                                "int8_conv1d")
    err = _conv_library().int8_mrf_conv(
        x.data_ptr(), sx.data_ptr(), int(finished),
        conv.packed.data_ptr(), conv.scale.data_ptr(), _ptr(conv.bias),
        _ptr(residual), out.data_ptr(), _ptr(amax_out), b, t,
        conv.in_channels, conv.out_channels, conv.taps, dilation,
        1.0 if slope is None else slope, branch_scale, mode,
        int(x.dtype == torch.bfloat16), geometry, _stream(x))
    if err != 0:
        raise RuntimeError(f"int8_conv1d launch failed: CUDA error {err}")
    int8_conv1d.launches += 1
    return out


int8_conv1d.launches = 0


def int8_conv_transpose1d(x: torch.Tensor, conv: QuantConvTranspose1d,
                          slope: Optional[float] = None,
                          sx: Optional[torch.Tensor] = None,
                          x_amax: Optional[torch.Tensor] = None,
                          amax_out: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """int8 transposed conv (upsample) of `lrelu(x)`, `x [B, T, C_in]` ->
    `[B, T_out, C_out]` in `x.dtype`, bias added in `x.dtype`. The input's
    scale, as for `int8_conv1d`: `sx` where given, else finished from the
    abs-max `x_amax`, else one `row_scale` launch; `amax_out` ([B] f32,
    zeroed by the caller) takes the max of `|lrelu(out)|` per row, the
    scale of the stage that reads the output. One launch of the GEMM
    kernel."""
    if sx is not None and x_amax is not None:
        raise ValueError("int8_conv_transpose1d takes `sx` or `x_amax`, not "
                         "both")
    if x.device.type == "cpu":
        if x_amax is not None:
            sx = _scale_of(x_amax)
        return _take_amax(int8_conv_transpose1d_reference(x, conv, slope, sx),
                          slope, amax_out)
    _check_cuda_input(x, conv, "int8_conv_transpose1d")
    b, t, _ = x.shape
    t_out = conv.out_length(t)
    if conv.padding < 0 or t < 1 or t_out < 1:
        raise ValueError(f"int8_conv_transpose1d: padding {conv.padding} and "
                         f"lengths {t} -> {t_out} do not fit the kernel")
    geometry = _upsample_geometry_ints(conv.in_channels, conv.out_channels,
                                       conv.taps, conv.stride,
                                       x.dtype == torch.float32)
    finished, sx = _input_scale(x, slope, sx, x_amax, amax_out,
                                "int8_conv_transpose1d")
    out = torch.empty(b, t_out, conv.out_channels, device=x.device,
                      dtype=x.dtype)
    err = _conv_library().int8_conv_transpose1d(
        x.data_ptr(), sx.data_ptr(), int(finished), conv.packed.data_ptr(),
        conv.packed_scale.data_ptr(), _ptr(conv.packed_bias), out.data_ptr(),
        _ptr(amax_out), b, t, t_out, conv.in_channels, conv.out_channels,
        conv.taps, conv.stride, conv.padding,
        1.0 if slope is None else slope, int(x.dtype == torch.bfloat16),
        geometry, _stream(x))
    if err != 0:
        raise RuntimeError(
            f"int8_conv_transpose1d launch failed: CUDA error {err}")
    int8_conv_transpose1d.launches += 1
    return out


int8_conv_transpose1d.launches = 0
