// Q1: one int8 convolution of a quantised HiFi-GAN MRF stage, with the
// activation scale of the conv that reads its output taken in its epilogue.
//
// Replaces lax.conv_general_dilated on int8 operands in
// wetts_tpu/models/hifigan_fast.py:_conv (q8=True), which the TPU ran on its
// matrix unit through XLA, and, for all but each stage's input, the XLA
// reduction that gives the activation scale (hifigan_fast.py:141). The
// wrapper is wetts_tpu_torch/models/quant.py:int8_conv1d, driven per stage by
// wetts_tpu_torch/models/mrf.py:mrf_stage_int8; activations are [B, T, C]
// (channels last), f32 or bf16:
//
//   sx     = sx_in[b], or max(amax_in[b], 1e-12) / 127 (true division)
//   xq     = clip(rint(lrelu(x[b]) / sx), -127, 127)                 (int8)
//   acc    = sum_{tap, ci} wq[co, ci, tap] * xq[t + tap*dil - pad, ci] (int32)
//   v      = rnd(f32(acc) * (sx * sw[co]));  v = rnd(v + bias[co]);
//   v      = rnd(v + res[b, t, co]);  out (op)= v
//   amax_out[b] = max(amax_out[b], max over the block's stored values of
//                 |lrelu(out)|)                            (if amax_out)
//
// with rnd the rounding to the activation type, x zero outside [0, T), `op`
// one of store / store-scaled / accumulate-scaled (kernel K1's three store
// modes) and lrelu rounded as PyTorch rounds it. The integer sums are
// exact, every float step is one IEEE operation, and a max does not depend
// on the order it is taken in, so the result differs from the plain PyTorch
// version only where the two round f32 to the output type, and the fused
// scale is bit-equal to a separate pass over the output.
//
// What bounds it: arithmetic. A v1 MRF stage does 126 C x C taps per output
// sample against 2 * C * 2 bytes of bf16 traffic, far above the int8
// tensor-core ridge (1979 TOP/s against 3.35 TB/s). Its first design
// (mma.sync fed by 32-bit shared loads, input staged and quantised before
// the first product, a scale pass before every conv) ran at a few percent
// of that. This one is kernel K1's (csrc/mrf_stage.cu) with int8 operands:
// - GEMM shape: M is time (64-row wgmma tiles, MT per tile), N the output
//   channels of the tile (16, 32, 64 or 128), K the input channels of one
//   tap; the taps are an outer loop over shifted rows of one shared input
//   tile. The products are wgmma m64nNk32 s8 x s8 -> s32.
// - Layout: both operands K-major without swizzle, [16-byte slice][row][16
//   bytes] (hopper.cuh), 16 int8 channels a slice, so a tap's shift is a
//   change of the descriptor's start address; rows padded to 1 (mod 8).
// - Persistent blocks: as many as the SMs hold (two an SM), each walking
//   its share of the (time, channel, batch) tiles, with the rings running
//   on from one tile to the next: the producers stage and stream the next
//   tile's input and weights while the consumers multiply and store this
//   one. Measured, a block that stages, multiplies and stores one tile
//   after another spent most of its time waiting on memory (PERF.md).
// - Weights are packed once per eval() (quant.py:pack_int8_weight) as
//   [tap][slice][C_out padded][16 B]; one warp streams tiles of (chunk of 8
//   slices, group of taps; about 16 KB) by bulk asynchronous copies
//   (cp.async.bulk) that complete on mbarriers, through a ring of 4 (2
//   where 4 would keep a second block off the SM).
// - The input tile, with the taps' halo, comes in chunks of 8 slices (128
//   channels) through a ring of 2: three producer warps load x, apply the
//   leaky relu, quantise (exactly as a true division, `quantize16`) and
//   store int8 slices, while the consumer warpgroup multiplies the chunk
//   before. Wide outputs take 128-channel tiles, so that the input is
//   quantised once per 128 output channels (64 positions a tile).
// - The epilogue goes through its own tiles of shared memory: the residual
//   (and, to accumulate, the output) tile comes in by 16-byte asynchronous
//   copies, all in flight before any store; each thread folds its sums
//   into the tile; whole 16-byte rows go out, and the same pass takes the
//   abs-max of what it stores (one warp reduction and one atomicMax on the
//   float's bits per warp and batch row), so the next conv needs no pass
//   over its input to find its scale.
// C_in must be a multiple of 32 and C_out of 8. The tile sizes, ring depths
// and shared-memory bytes come from quant.py:int8_conv_geometry; they are
// re-derived here and a disagreement is cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr int kXProducers = 96;      // three warps load the input tile
constexpr int kCs = 8;               // 16-byte slices per chunk: 128 channels
constexpr int kMaxXStages = 2;
constexpr int kMaxWStages = 4;
constexpr int kBarrierBytes = 8 * 2 * (kMaxXStages + kMaxWStages);
constexpr int kSmemLimit = 232448;   // what one block may use on sm_90
constexpr int kTwoBlocks = 115712;   // at most this, two blocks share an SM
constexpr int kConsumers = 128;      // one consumer warpgroup

// ---- the activation type --------------------------------------------------

template <typename XT> struct Io;

template <> struct Io<float> {
  static constexpr int kPerGranule = 4;  // values per 16 bytes
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ void unpack(const uint4& g, float* v) {
    v[0] = __uint_as_float(g.x); v[1] = __uint_as_float(g.y);
    v[2] = __uint_as_float(g.z); v[3] = __uint_as_float(g.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <> struct Io<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kPerGranule = 8;
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float2 half2f(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
  static __device__ __forceinline__ uint32_t f2half(float a, float b) {
    const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&r);
  }
  static __device__ __forceinline__ void unpack(const uint4& g, float* v) {
    const float2 a = half2f(g.x), b = half2f(g.y), c = half2f(g.z),
                 d = half2f(g.w);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    v[4] = c.x; v[5] = c.y; v[6] = d.x; v[7] = d.y;
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(f2half(v[0], v[1]), f2half(v[2], v[3]),
                      f2half(v[4], v[5]), f2half(v[6], v[7]));
  }
  static __device__ __forceinline__ float2 load2(const T* p) {
    return half2f(*reinterpret_cast<const uint32_t*>(p));
  }
  static __device__ __forceinline__ void store2(T* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = f2half(a, b);
  }
};

// lrelu in the activation type (its product rounded as PyTorch rounds it)
template <typename XT>
__device__ __forceinline__ float lrelu(float v, float slope) {
  return v > 0.f ? v : Io<XT>::rnd(__fmul_rn(v, slope));
}

// f32 -> the nearest bf16 value (ties to even), as f32, by integer
// arithmetic: the same value as __float2bfloat16_rn for every finite f32,
// without the conversion unit
__device__ __forceinline__ float round_bf16(float f) {
  const uint32_t u = __float_as_uint(f);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// clip(rint(lrelu(v) / sx), -127, 127) of a row's 16 channels, packed, with
// the quotient exactly as __fdiv_rn gives it. The product with the
// reciprocal, p = lrelu(v) * rcp, lies within 3 * 2^-24 |p| of the true
// quotient and so within 2^-20 |p| of the correctly rounded one, so rint(p)
// is the right integer unless p lies that close to a half-integer; only
// then (rarely) are the 16 divisions taken. rint and the conversion to an
// integer go through the f32 adder (x + 1.5 * 2^23 rounds x to an integer,
// ties to even, for |x| < 2^22), so that the loop uses no conversion unit.
template <typename XT>
__device__ __forceinline__ uint4 quantize16(const float* v, float slope,
                                            float sx, float rcp) {
  constexpr float kMagic = 12582912.0f;     // 1.5 * 2^23, bits 0x4B400000
  float l[16], p[16];
  bool near = false;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float n = __fmul_rn(v[j], slope);
    if constexpr (!std::is_same<XT, float>::value) n = round_bf16(n);
    l[j] = v[j] > 0.f ? v[j] : n;
    p[j] = __fmul_rn(l[j], rcp);
    const float r = __fsub_rn(__fadd_rn(p[j], kMagic), kMagic);
    const float tie = fabsf(__fsub_rn(fabsf(__fsub_rn(p[j], r)), 0.5f));
    near |= tie <= 0x1p-20f * fabsf(p[j]);
  }
  if (near) {
#pragma unroll
    for (int j = 0; j < 16; ++j) p[j] = __fdiv_rn(l[j], sx);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    // clipping to the integers +-127 first changes no rounding
    const float c = fminf(fmaxf(p[j], -127.f), 127.f);
    const int q = __float_as_int(__fadd_rn(c, kMagic)) - 0x4B400000;
    w[j / 4] |= (uint32_t)(q & 0xFF) << (8 * (j % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ---- geometry, as wetts_tpu_torch/models/quant.py:int8_conv_geometry ------

struct Geometry {
  int nt, mt, rows_p, n_slices, co_p, x_stages, w_stages, tps, smem;
};

inline Geometry derive_geometry(int C_in, int C_out, int taps, int dil,
                                bool f32) {
  Geometry g;
  // a tile of 64 x 128 outputs (128 x 64, 256 x 32, 512 x 16 for narrower
  // outputs), one consumer warpgroup, two blocks an SM where they fit
  g.nt = C_out <= 16 ? 16 : C_out <= 32 ? 32 : C_out <= 64 ? 64 : 128;
  g.mt = g.nt == 128 ? 1 : 128 / g.nt;
  const int rows = g.mt * 64 + (taps - 1) * dil;
  g.rows_p = (rows + 6) / 8 * 8 + 1;
  g.n_slices = C_in / 16;
  g.co_p = (C_out + g.nt - 1) / g.nt * g.nt;
  const int chunk_slices = g.n_slices < kCs ? g.n_slices : kCs;
  // two input stages even for one chunk: the next tile's comes in while
  // the consumers work on this one's
  g.x_stages = kMaxXStages;
  const int tps = g.nt == 128 ? 1 : 128 / g.nt;  // taps per weight tile
  g.tps = tps < taps ? tps : taps;
  const int x_ring = g.x_stages * chunk_slices * g.rows_p * 16;
  const int w_tile = g.tps * chunk_slices * g.nt * 16;
  // the epilogue's tiles of the residual and the output, beside the rings
  const int tiles = g.mt * 64 * (g.nt + 8) * (f32 ? 4 : 2) * 2;
  g.w_stages = kMaxWStages;
  g.smem = x_ring + g.w_stages * w_tile + tiles + kBarrierBytes;
  if (g.smem > kTwoBlocks) {  // a shallower weight ring keeps two an SM
    g.w_stages = 2;
    g.smem = x_ring + g.w_stages * w_tile + tiles + kBarrierBytes;
  }
  return g;
}

struct Args {
  const void* x;        // [B, T, C_in]
  const float* sx;      // [B]: the scale, or the abs-max to finish
  const int8_t* wp;     // [taps][n_slices][co_p][16]
  const float* sw;      // [C_out]
  const void* bias;     // [C_out] in the activation type, or null
  const void* res;      // [B, T, C_out] or null
  void* out;            // [B, T, C_out]
  unsigned* amax;       // [B] float bits to take the max into, or null
  int B, T, C_in, C_out, taps, dil, rows_p, n_slices, co_p, x_stages;
  int w_stages, tps, smem_bytes, sx_finished, mode;
  float slope, scale;
};

// One chunk of the input tile, by the 96 producer threads: rows t_first ..
// t_first + rows of channels ci0 .. ci0 + 16 ns, zero outside [0, T),
// quantised, into [slice][row][16 bytes]. Each thread loads four units (a
// row's 16 channels) before it quantises and stores them.
template <typename XT>
__device__ __forceinline__ void stage_input(uint8_t* tile, const XT* xb,
                                            int ptid, int ns, int ci0,
                                            int t_first, int rows, int rows_p,
                                            int T, int C, float slope,
                                            float sx) {
  constexpr int kGran = 16 / Io<XT>::kPerGranule;  // 16-byte loads a unit
  const int units = rows * ns;
  const float rcp = __frcp_rn(sx);
  for (int u0 = ptid; u0 < units; u0 += 4 * kXProducers) {
    uint4 raw[4][kGran];
    bool ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = u0 + i * kXProducers;
      const int r = u / ns, s = u - r * ns;
      const int t = t_first + r;
      ok[i] = u < units && t >= 0 && t < T;
      if (ok[i]) {
        const uint4* src = reinterpret_cast<const uint4*>(
            xb + (size_t)t * C + ci0 + 16 * s);
#pragma unroll
        for (int q = 0; q < kGran; ++q) raw[i][q] = src[q];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = u0 + i * kXProducers;
      if (u >= units) break;
      const int r = u / ns, s = u - r * ns;
      uint4 packed = make_uint4(0, 0, 0, 0);
      if (ok[i]) {
        float v[16];
#pragma unroll
        for (int q = 0; q < kGran; ++q)
          Io<XT>::unpack(raw[i][q], v + q * Io<XT>::kPerGranule);
        packed = quantize16<XT>(v, slope, sx, rcp);
      }
      *reinterpret_cast<uint4*>(tile + (s * rows_p + r) * 16) = packed;
    }
  }
}

// ---- the kernel -----------------------------------------------------------

// The activation scale of batch row b (finished here from an abs-max)
__device__ __forceinline__ float row_scale_of(const Args& a, int b) {
  return a.sx_finished ? a.sx[b] : __fdiv_rn(fmaxf(a.sx[b], 1e-12f), 127.f);
}

template <typename XT, int NT, int MT>
__global__ void __launch_bounds__(kConsumers + 128, 2)
int8_mrf_conv_kernel(const Args a) {
  constexpr int TT = MT * 64;               // positions per tile
  constexpr uint32_t kRow = (NT + 8) * sizeof(XT);
  extern __shared__ __align__(128) uint8_t smem[];

  // [stage][slice][row][16 B] inputs, [stage][tap of the group][slice]
  // [channel][16 B] weights, the epilogue's residual and output tiles, then
  // the barriers
  const int chunk_slices = min(kCs, a.n_slices);
  const uint32_t x_stage = chunk_slices * a.rows_p * 16;
  const uint32_t w_tap = chunk_slices * NT * 16;
  const uint32_t w_stage = a.tps * w_tap;
  uint8_t* x_ring = smem;
  uint8_t* w_ring = smem + a.x_stages * x_stage;
  uint8_t* tile_r = w_ring + a.w_stages * w_stage;
  uint8_t* tile_o = tile_r + TT * kRow;
  const uint32_t bars = smem_addr(smem + a.smem_bytes - kBarrierBytes);
  const uint32_t x_full = bars, x_empty = bars + 8 * kMaxXStages;
  const uint32_t w_full = bars + 16 * kMaxXStages;
  const uint32_t w_empty = w_full + 8 * kMaxWStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int halo = (a.taps - 1) * a.dil;
  const int rows = TT + halo;
  const int n_chunks = (a.n_slices + kCs - 1) / kCs;
  // the tiles: time fastest, then output channels, then the batch row, so
  // that the blocks at work at one time share weights and input rows in L2
  const int n_t = (a.T + TT - 1) / TT, n_co = a.co_p / NT;
  const int n_tiles = n_t * n_co * a.B;

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.x_stages; ++i) {
      mbar_init(x_full + 8 * i, kXProducers);
      mbar_init(x_empty + 8 * i, 4);
    }
    for (int i = 0; i < a.w_stages; ++i) {
      mbar_init(w_full + 8 * i, 1);
      mbar_init(w_empty + 8 * i, 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4) {
    if (warp == 4) {
      // ---- weight producer: one warp streams the tiles of (chunk, group
      // of `tps` taps) of every tile in turn, one bulk copy per (tap, slice)
      int slot = 0;
      uint32_t parity = 1;  // a fresh slot is free
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int co0 = (tile / n_t) % n_co * NT;
        for (int c = 0; c < n_chunks; ++c) {
          const int ns = min(kCs, a.n_slices - c * kCs);
          for (int tap0 = 0; tap0 < a.taps; tap0 += a.tps) {
            const int n_copies = min(a.tps, a.taps - tap0) * ns;
            mbar_wait(w_empty + 8 * slot, parity);
            if (lane == 0)
              mbar_arrive_expect_tx(w_full + 8 * slot, n_copies * NT * 16);
            __syncwarp();
            for (int i = lane; i < n_copies; i += 32) {
              const int s = i % ns, tg = i / ns;
              const size_t row =
                  ((size_t)(tap0 + tg) * a.n_slices + c * kCs + s) * a.co_p
                  + co0;
              bulk_copy(smem_addr(w_ring + slot * w_stage + tg * w_tap
                                  + s * NT * 16),
                        a.wp + row * 16, NT * 16, w_full + 8 * slot);
            }
            if (++slot == a.w_stages) { slot = 0; parity ^= 1; }
          }
        }
      }
    } else {
      // ---- input producers: per tile, rows t0 - pad .. t0 + TT + halo -
      // pad of each chunk of channels, quantised; the next tile's while the
      // consumers finish this one ----
      const int ptid = threadIdx.x - (kConsumers + 32);
      int seq = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int t0 = tile % n_t * TT, b = tile / (n_t * n_co);
        const XT* xb = static_cast<const XT*>(a.x) + (size_t)b * a.T * a.C_in;
        const float sx = row_scale_of(a, b);
        for (int c = 0; c < n_chunks; ++c, ++seq) {
          const int slot = seq % a.x_stages;
          mbar_wait(x_empty + 8 * slot, ((seq / a.x_stages) & 1) ^ 1);
          const int ns = min(kCs, a.n_slices - c * kCs);
          stage_input<XT>(x_ring + slot * x_stage, xb, ptid, ns,
                          c * kCs * 16, t0 - halo / 2, rows, a.rows_p, a.T,
                          a.C_in, a.slope, sx);
          // the stores above are read by the tensor cores' asynchronous
          // proxy
          fence_proxy_async();
          mbar_arrive(x_full + 8 * slot);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: per tile, MT 64-row tiles of sums ----
  const XT* res = static_cast<const XT*>(a.res);
  const XT* bias = static_cast<const XT*>(a.bias);
  XT* out = static_cast<XT*>(a.out);
  const bool accumulate = a.mode == 2;
  constexpr int kGch = Io<XT>::kPerGranule;   // channels per 16 bytes
  constexpr int kGpr = NT / kGch;             // granules per row
  const int tid = threadIdx.x;
  const int lr = (warp % 4) * 16 + lane / 4;
  const int lc = (lane % 4) * 2;
  int seq = 0, wslot = 0;
  uint32_t wparity = 0;
  int acc[MT][NT / 2];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int t0 = tile % n_t * TT, co0 = (tile / n_t) % n_co * NT;
    const int b = tile / (n_t * n_co);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[m][i] = 0;

    int prev_wslot = 0, prev_xs = 0;
    bool first = true;
    for (int c = 0; c < n_chunks; ++c, ++seq) {
      const int xs = seq % a.x_stages;
      mbar_wait(x_full + 8 * xs, (seq / a.x_stages) & 1);
      const int nk = min(kCs, a.n_slices - c * kCs) / 2;
      const uint32_t xbase = smem_addr(x_ring + xs * x_stage);
      for (int tap0 = 0; tap0 < a.taps; tap0 += a.tps) {
        mbar_wait(w_full + 8 * wslot, wparity);
        const uint32_t wbase = smem_addr(w_ring + wslot * w_stage);
#pragma unroll
        for (int m = 0; m < MT; ++m) fence_sums(acc[m]);
        wgmma_fence();
        const int n_taps = min(a.tps, a.taps - tap0);
        for (int tg = 0; tg < n_taps; ++tg) {
          for (int ks = 0; ks < nk; ++ks) {
            // the tap's shift is a change of the start address by whole
            // rows
            const uint32_t a0 =
                xbase + (2 * ks * a.rows_p + (tap0 + tg) * a.dil) * 16;
            const uint64_t db = operand_desc(
                wbase + tg * w_tap + 2 * ks * NT * 16, NT * 16, 128);
#pragma unroll
            for (int m = 0; m < MT; ++m)
              Wgmma<NT>::s8(acc[m],
                            operand_desc(a0 + m * 64 * 16, a.rows_p * 16,
                                         128),
                            db);
          }
        }
        wgmma_commit();
        if (!first) {
          // the products of the group before are done: hand its weight
          // stage and, at a chunk's first group, the chunk before back
          wgmma_wait<1>();
          if (lane == 0) {
            mbar_arrive(w_empty + 8 * prev_wslot);
            if (tap0 == 0) mbar_arrive(x_empty + 8 * prev_xs);
          }
        }
        first = false;
        prev_wslot = wslot;
        if (++wslot == a.w_stages) { wslot = 0; wparity ^= 1; }
      }
      prev_xs = xs;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_sums(acc[m]);
    if (lane == 0) {
      mbar_arrive(w_empty + 8 * prev_wslot);
      mbar_arrive(x_empty + 8 * prev_xs);
    }

    // epilogue, through shared memory so that global memory sees whole
    // rows: a thread holds rows lane / 4 and + 8 of its warp's 16 in each
    // 64-row tile and the channel pairs 8 j + 2 (lane % 4). (a) The
    // residual tile and, to accumulate, the output's tile come in by
    // 16-byte asynchronous copies, all in flight at once; (b) each thread
    // folds its sums into the residual tile's elements, which it alone
    // touches; (c) the tile goes out in 16-byte stores, added to the
    // output's tile where it accumulates, and the abs-max of the leaky relu
    // of what is stored is taken on the way. Rows are padded by 8 values
    // against bank conflicts.
    const float sx = row_scale_of(a, b);
    const size_t base0 = ((size_t)b * a.T + t0) * a.C_out + co0;
    consumer_barrier<kConsumers>();  // the tile before is out
    if (res != nullptr || accumulate) {
      for (int i = tid; i < TT * kGpr; i += kConsumers) {
        const int row = i / kGpr, g = i - row * kGpr;
        const bool ok = t0 + row < a.T && co0 + g * kGch < a.C_out;
        const size_t at = ok ? base0 + (size_t)row * a.C_out + g * kGch : 0;
        const uint32_t off = row * kRow + g * 16;
        if (res != nullptr)
          cp_async<16>(smem_addr(tile_r + off), res + at, ok);
        if (accumulate) cp_async<16>(smem_addr(tile_o + off), out + at, ok);
      }
      cp_async_wait_all();
    }
    consumer_barrier<kConsumers>();
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int col = lc + 8 * j;
      const int co = co0 + col;
      if (co >= a.C_out) continue;   // C_out % 8 == 0: co + 1 is in too
      const float s0 = __fmul_rn(sx, a.sw[co]);
      const float s1 = __fmul_rn(sx, a.sw[co + 1]);
      const float2 bv = bias != nullptr ? Io<XT>::load2(bias + co)
                                        : make_float2(0.f, 0.f);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t off =
              (lr + m * 64 + h * 8) * kRow + col * sizeof(XT);
          float v0 = Io<XT>::rnd(
              __fmul_rn(__int2float_rn(acc[m][4 * j + 2 * h]), s0));
          float v1 = Io<XT>::rnd(
              __fmul_rn(__int2float_rn(acc[m][4 * j + 2 * h + 1]), s1));
          if (bias != nullptr) {
            v0 = Io<XT>::rnd(__fadd_rn(v0, bv.x));
            v1 = Io<XT>::rnd(__fadd_rn(v1, bv.y));
          }
          if (res != nullptr) {
            const float2 r =
                Io<XT>::load2(reinterpret_cast<const XT*>(tile_r + off));
            v0 = Io<XT>::rnd(__fadd_rn(v0, r.x));
            v1 = Io<XT>::rnd(__fadd_rn(v1, r.y));
          }
          if (a.mode != 0) {
            v0 = Io<XT>::rnd(__fmul_rn(v0, a.scale));
            v1 = Io<XT>::rnd(__fmul_rn(v1, a.scale));
          }
          Io<XT>::store2(reinterpret_cast<XT*>(tile_r + off), v0, v1);
        }
    }
    consumer_barrier<kConsumers>();
    float amax = 0.f;
    for (int i = tid; i < TT * kGpr; i += kConsumers) {
      const int row = i / kGpr, g = i - row * kGpr;
      if (t0 + row >= a.T || co0 + g * kGch >= a.C_out) continue;
      const uint32_t off = row * kRow + g * 16;
      uint4 gr = *reinterpret_cast<const uint4*>(tile_r + off);
      float v[kGch];
      Io<XT>::unpack(gr, v);
      if (accumulate) {
        float o[kGch];
        Io<XT>::unpack(*reinterpret_cast<const uint4*>(tile_o + off), o);
#pragma unroll
        for (int e = 0; e < kGch; ++e)
          v[e] = Io<XT>::rnd(__fadd_rn(o[e], v[e]));
        gr = Io<XT>::pack(v);
      }
      *reinterpret_cast<uint4*>(out + base0 + (size_t)row * a.C_out
                                + g * kGch) = gr;
#pragma unroll
      for (int e = 0; e < kGch; ++e)
        amax = fmaxf(amax, fabsf(lrelu<XT>(v[e], a.slope)));
    }
    if (a.amax != nullptr) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      // non-negative floats order as their bit patterns
      if (lane == 0) atomicMax(a.amax + b, __float_as_uint(amax));
    }
  }
}

template <typename XT, int NT, int MT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static std::atomic<bool> prepared[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  auto kernel = int8_mrf_conv_kernel<XT, NT, MT>;
  e = allow_shared_memory(kernel, dev, prepared);
  if (e != cudaSuccess) return e;
  // persistent blocks: as many as the SMs hold at once, each walking its
  // share of the tiles
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kConsumers + 128, a.smem_bytes);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (long long)(a.T + MT * 64 - 1) / (MT * 64)
                          * (a.co_p / NT) * a.B;
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles
                                                         : sms * per_sm);
  kernel<<<grid, kConsumers + 128, a.smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_width(const Args& a, int nt, cudaStream_t stream) {
  switch (nt) {
    case 16: return launch<XT, 16, 8>(a, stream);
    case 32: return launch<XT, 32, 4>(a, stream);
    case 64: return launch<XT, 64, 2>(a, stream);
    case 128: return launch<XT, 128, 1>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, res, out: [B, T, C] contiguous, f32 or bf16 (`is_bf16`); res may be
// null and out may be res, not x. sx: [B] f32, the activation scale
// (`sx_finished` 1) or the abs-max of lrelu(x) per row (0), finished here.
// wp: the int8 weights packed by quant.py:pack_int8_weight; sw: [C_out] f32;
// bias in the activation type or null. mode 0: out = v; 1: out = scale * v;
// 2: out += scale * v. amax: [B] f32 (zeroed by the caller) that takes the
// max of |lrelu(out)| over what this launch stores, or null. geometry: the 9
// ints of int8_conv_geometry (nt, mt, rows_p, n_slices, co_p, x_stages,
// w_stages, taps per weight stage, smem_bytes). Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int int8_mrf_conv(const void* x, const float* sx, int sx_finished,
                             const int8_t* wp, const float* sw,
                             const void* bias, const void* res, void* out,
                             float* amax, int B, int T, int C_in, int C_out,
                             int K, int dil, float slope, float scale,
                             int mode, int is_bf16, const int* geometry,
                             void* stream) {
  if (B < 1 || T < 1 || C_in < 32 || C_in % 32 != 0 || C_out < 8
      || C_out % 8 != 0 || K < 1 || K % 2 == 0 || dil < 1 || mode < 0
      || mode > 2)
    return (int)cudaErrorInvalidValue;
  const Geometry g = derive_geometry(C_in, C_out, K, dil, !is_bf16);
  const int mine[9] = {g.nt,       g.mt,       g.rows_p,
                       g.n_slices, g.co_p,     g.x_stages,
                       g.w_stages, g.tps,      g.smem};
  for (int i = 0; i < 9; ++i)
    if (geometry[i] != mine[i]) return (int)cudaErrorInvalidValue;
  if (g.smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x; a.sx = sx; a.wp = wp; a.sw = sw; a.bias = bias; a.res = res;
  a.out = out; a.amax = reinterpret_cast<unsigned*>(amax);
  a.B = B; a.T = T; a.C_in = C_in; a.C_out = C_out; a.taps = K; a.dil = dil;
  a.rows_p = g.rows_p; a.n_slices = g.n_slices; a.co_p = g.co_p;
  a.x_stages = g.x_stages; a.w_stages = g.w_stages; a.tps = g.tps;
  a.smem_bytes = g.smem;
  a.sx_finished = sx_finished; a.mode = mode;
  a.slope = slope; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch_width<__nv_bfloat16>(a, g.nt, s);
  return (int)launch_width<float>(a, g.nt, s);
}
