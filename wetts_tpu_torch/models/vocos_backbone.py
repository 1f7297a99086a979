"""The Vocos decoder's backbone on channels-last activations: the wrappers
of `csrc/vocos_backbone.cu`, on a card only.

`VocosGenerator` (models/vocos.py) takes this path for inference on a
card: its in_conv -> norm_pre -> ConvNeXt layers -> norm_post -> out_conv
run over [rows x (T + 1), C] rows, so that the 1x1 convs are GEMMs whose
operands are both K-major, and no transpose is left:

- `gemm` is one launch of `out = epi(x @ w^T)` with the elementwise work of
  the layer in its epilogue (`BIAS` with an optional per-row-of-batch
  vector, `GELU`, `RESIDUAL`: x + scale * (acc + bias) in place). It runs
  the hand-written kernel, f32 by split TF32 on the tensor cores
  (`wgmma`), counted in `gemm.launches`.
- `rownorm` is one launch of the depthwise conv of 3 taps (zero-padded
  inside each row of frames) and LayerNorm, or LayerNorm alone, counted in
  `rownorm.launches`.
- `pack_weight` lays a [N, K] weight out as the kernel streams it, in TF32
  hi and lo parts (`VocosGenerator.packed_weights` keeps a decoder's until
  one of its convs' weights changes).
- `backbone` runs the whole chain: 18 GEMM and 10 row launches for the
  published 8 layers, beside the reflection pad and the speaker's cond;
  `check_widths` says which decoders it takes.
Every wrapper raises off a card (the CPU keeps the decoder's modules,
`VocosGenerator.backbone_modules`). The kernels take f32 only; the note at the top of the CUDA source has the
design and what bounds it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from wetts_tpu_torch.models.mrf import split_tf32
from wetts_tpu_torch.utils import cuda_build

BIAS, GELU, RESIDUAL = 0, 1, 2
TILE_N = 128       # output channels a block: the packed weights' N padding
CHUNK_K = 32       # values of K a packed chunk holds (8 slices of 4)
LN_EPS = 1e-5
MAX_NORM_CHANNELS = 1024  # the row kernel's widest row


# the order of K inside a stage's 32 values as the kernel's products take
# them: K step t, column c reads k = 8 (c % 4) + 2 t + c // 4 (a thread
# holds the activations of 8 consecutive k and gives column c % 4 of each
# step from its first half of a pair, column c % 4 + 4 from the second)
K_ORDER = tuple(8 * (c % 4) + 2 * t + c // 4
                for t in range(CHUNK_K // 8) for c in range(8))


def _swizzle(p: torch.Tensor) -> torch.Tensor:
    """[..., TILE_N rows, 8 chunks, 4] -> the same with chunk j of row r at
    j ^ (r % 8), the 128-byte swizzle the kernel's tiles are read in (its
    own inverse)."""
    rows = torch.arange(TILE_N, device=p.device)[:, None]
    chunks = torch.arange(8, device=p.device)[None, :] ^ (rows % 8)
    return p[..., rows, chunks, :]


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """[N, K] f32 -> the kernel's layout [N tile][K chunk of 32][part]
    [TILE_N channels][8 swizzled 16-byte chunks][4]: part 0 the TF32 hi
    parts, part 1 the lo parts; each chunk of K in `K_ORDER`; zeros past N
    and K. A stage's hi and lo tiles are contiguous."""
    n, k = w.shape
    n_p, k_p = -(-n // TILE_N) * TILE_N, -(-k // CHUNK_K) * CHUNK_K
    p = w.new_zeros(n_p, k_p)
    p[:n, :k] = w.detach()
    order = torch.tensor(K_ORDER, device=w.device)
    # [N tile, channel, K chunk, 32] in K_ORDER -> [N tile, K chunk,
    # channel, 16-byte chunk, 4]
    p = p.view(n_p // TILE_N, TILE_N, k_p // CHUNK_K, CHUNK_K)[..., order]
    p = _swizzle(p.reshape(n_p // TILE_N, TILE_N, k_p // CHUNK_K, 8, 4)
                 .permute(0, 2, 1, 3, 4))
    return torch.stack(split_tf32(p.contiguous()), dim=2).contiguous()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("vocos_backbone")
    lib.vocos_gemm.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                               + [ctypes.c_void_p])
    lib.vocos_gemm.restype = ctypes.c_int
    lib.vocos_rownorm.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                                  + [ctypes.c_float, ctypes.c_void_p])
    lib.vocos_rownorm.restype = ctypes.c_int
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def gemm(x: torch.Tensor, w: torch.Tensor, packed: Optional[torch.Tensor],
         bias: torch.Tensor, mode: int = BIAS,
         aux: Optional[torch.Tensor] = None, t1: int = 1,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [M, K] @ w[N, K]^T with the epilogue `mode`:
    BIAS: + bias, + aux[m // t1] where `aux` [M // t1, N] is given;
    GELU: gelu(+ bias); RESIDUAL: out + aux * (+ bias), `aux` the scale [N]
    and `out` [M, N] the residual, written in place. Returns `out`, [M, N]
    (on a card a view of rows padded to a multiple of 4 where N is not
    one). `packed` is `pack_weight(w)`."""
    m, k = x.shape
    n = w.shape[0]
    if (not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous()
            or packed is None or packed.device != x.device):
        raise ValueError("gemm takes a contiguous f32 x on a card and "
                         "packed weights on its device")
    if out is None:
        out = x.new_empty(m, -(-n // 4) * 4)[:, :n]
    if m:
        err = _library().vocos_gemm(
            x.data_ptr(), packed.data_ptr(), bias.data_ptr(), _ptr(aux),
            out.data_ptr() if mode == RESIDUAL else None, out.data_ptr(),
            m, n, k, out.stride(0), t1, mode,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"vocos_gemm launch failed: CUDA error {err}")
        gemm.launches += 1
    return out


def rownorm(x: torch.Tensor, t1: int, norm, dw_conv=None) -> torch.Tensor:
    """x [M, C] as rows of t1 frames -> LayerNorm(dw_conv(x)) [M, C] (the
    conv of 3 taps zero-padded inside each row; without it LayerNorm
    alone), `norm` a `layers.LayerNorm` and `dw_conv` a depthwise
    `layers.Conv1d`."""
    m, c = x.shape
    if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("rownorm takes a contiguous f32 x on a card")
    y = torch.empty_like(x)
    if m:
        dw_w = None if dw_conv is None else dw_conv.weight
        dw_b = None if dw_conv is None else dw_conv.bias
        err = _library().vocos_rownorm(
            x.data_ptr(), y.data_ptr(), _ptr(dw_w), _ptr(dw_b),
            norm.gamma.data_ptr(), norm.beta.data_ptr(), m, t1, c, LN_EPS,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"vocos_rownorm launch failed: CUDA error "
                               f"{err}")
        rownorm.launches += 1
    return y


gemm.launches = 0
rownorm.launches = 0


def convs(dec) -> list:
    """dec's 1x1 convs in the order the backbone runs them."""
    out = [dec.in_conv]
    for layer in dec.layers:
        out += [layer.pw_conv1, layer.pw_conv2]
    return out + [dec.out_conv]


def applies(dec, x: torch.Tensor) -> bool:
    """Whether `dec` (a VocosGenerator) decodes x [B, C, T] on this path:
    x f32 on a card, no gradient recorded, and nothing exporting, compiling
    or tracing."""
    return (x.is_cuda and x.dtype == torch.float32
            and not torch.is_grad_enabled()
            and not torch.compiler.is_compiling()
            and not torch.compiler.is_exporting()
            and not torch.jit.is_tracing())


def check_widths(dec) -> None:
    """Raise ValueError where `dec`'s widths are ones the kernels do not
    take: the input's, the LayerNorm's and the hidden channel counts must
    be multiples of 4 (rows of 16-byte granules), the LayerNorm's at most
    MAX_NORM_CHANNELS (one warp a row); the output's may be any."""
    widths = {"input": dec.in_conv.weight.shape[1],
              "LayerNorm": dec.in_conv.weight.shape[0]}
    if len(dec.layers):
        widths["hidden"] = dec.layers[0].pw_conv1.weight.shape[0]
    for name, c in widths.items():
        if c % 4:
            raise ValueError(f"the Vocos backbone kernels take {name} "
                             f"widths that are multiples of 4, not {c}")
    if widths["LayerNorm"] > MAX_NORM_CHANNELS:
        raise ValueError(f"the Vocos backbone kernels take LayerNorms of at "
                         f"most {MAX_NORM_CHANNELS} channels, not "
                         f"{widths['LayerNorm']}")


def backbone(dec, x: torch.Tensor, g: Optional[torch.Tensor]
             ) -> torch.Tensor:
    """dec's in_conv through out_conv on the kernels, for x [B, C_in, T] on
    a card (any strides; the engine's is a view of channels-last z) and g
    [B, gin, 1] or None -> [B, T + 1, C_out] channels last (a view of rows
    padded to a multiple of 4). Raises ValueError for fewer than 2 frames
    (as the module path's reflection pad does), for input or weights that
    are not f32 on one card, and for widths the kernels do not take
    (`check_widths`)."""
    b, _, t = x.shape
    if t < 2:
        raise ValueError(f"the Vocos decoder's reflection pad needs at "
                         f"least 2 frames, got {t}")
    check_widths(dec)
    w = dec.in_conv.weight
    if not (x.is_cuda and x.dtype == w.dtype == torch.float32
            and w.device == x.device):
        raise ValueError(f"the Vocos backbone kernels take f32 input and "
                         f"weights on one card, not {x.dtype} on {x.device} "
                         f"and {w.dtype} on {w.device}")
    t1 = t + 1
    z = x.transpose(1, 2)
    # the reflection pad of one frame: frame 1, then the frames
    zp = torch.cat([z[:, 1:2], z], dim=1).reshape(b * t1, -1)
    cond = None
    if g is not None and hasattr(dec, "cond"):
        cond = dec.cond(g)[:, :, 0].contiguous()
    packed = iter(dec.packed_weights())

    def gemm_of(conv, y, mode=BIAS, aux=None, out=None):
        return gemm(y, conv.weight[:, :, 0], next(packed), conv.bias, mode,
                    aux, t1, out)

    xs = rownorm(gemm_of(dec.in_conv, zp, aux=cond), t1, dec.norm_pre)
    for layer in dec.layers:
        y = rownorm(xs, t1, layer.norm, layer.dw_conv)
        y = gemm_of(layer.pw_conv1, y, GELU)
        gemm_of(layer.pw_conv2, y, RESIDUAL, layer.scale, out=xs)
    y = rownorm(xs, t1, dec.norm_post)
    return gemm_of(dec.out_conv, y).unflatten(0, (b, t1))
