// K1: one convolution of a HiFi-GAN multi-receptive-field (MRF) stage as an
// implicit GEMM on Hopper's tensor cores, with the stage's elementwise work
// fused into its load and its epilogue.
//
// Replaces wetts_tpu/models/mrf_pallas.py:mrf_stage_pallas, the Pallas TPU
// kernel that runs a whole MRF stage in the TPU's space-to-depth layout and
// computes its block-Toeplitz products in its own body. Here the wrapper
// (wetts_tpu_torch/models/mrf.py:mrf_stage) launches this kernel once per
// conv of the stage, 18 times for a VITS-base stage, on [B, T, C] channels-
// last activations:
//
//   out[b, t, o] (op)= scale * (bias[o] + res[b, t, o]
//                      + sum_{k, i} w[o, i, k] * lrelu(x[b, t + k*dil - pad, i]))
//
// with x read as zero outside [0, T) (each conv zero-pads its own input) and
// `op` one of store / store-scaled / accumulate-scaled, so the residual add
// and the mean over the stage's branches cost no separate pass. The products
// are wgmma instructions written here; no library is called.
//
// What bounds it: by the count of its work, arithmetic. A v1 stage does 126
// C x C taps per output sample (2*C*C*126 flops) against 2*C activation
// values of traffic, far above the ridge of either tensor-core rate (989
// TFLOP/s bf16, 495 TF32). As built, one launch per conv, it also streams
// every weight tile once per block from L2 and reads and writes the
// activations once per conv, and measured, the memory system holds it back
// as much as the products do (PERF.md). The design:
// - GEMM shape: M is time (64-row wgmma tiles, MT per consumer warpgroup),
//   N the output channels of the block (16, 32, 64 or, in f32, 128; the
//   next blockIdx.y beyond that), K the input channels of one tap. The
//   taps are an outer loop over shifted rows of one shared input tile.
// - Layout: both operands are K-major without swizzle, stored
//   [16-byte K slice][row][16 bytes]: an 8-row core matrix is 128 contiguous
//   bytes, 8-row groups are 128 bytes apart and K slices `rows * 16` bytes
//   apart, so a shift by k*dil rows is a 16-byte-aligned change of the
//   descriptor's start address (the swizzled layouts do not allow that).
//   The row count is padded to 1 (mod 8) so that the producers' stores of
//   one row's slices fall into different banks.
// - Weights are packed once on the host side as [tap][slice][C_out][16 B]
//   (zero-padded to an even slice count and to a multiple of N): the run of
//   one (tap, slice) is contiguous, so one warp streams each tile of (chunk
//   of 8 slices, group of taps; about 16 KB) by bulk asynchronous copies
//   (cp.async.bulk) that complete on an mbarrier, through a ring of 3-4.
// - The input tile, with the taps' halo, comes in chunks of 8 slices (64
//   bf16 / 32 f32 channels) through a ring of 2: three producer warps bring
//   a chunk by cp.async (all of a thread's copies in flight at once), then
//   each applies the leaky relu in place to what it copied, while the
//   consumers multiply the previous chunk; mbarriers hand the stages over.
// - bf16 instance: bf16 tiles (the leaky relu rounded to bf16 as PyTorch
//   rounds it), wgmma m64nNk16 bf16 -> f32. A block is one consumer
//   warpgroup and the producer warpgroup, 128 positions x 64 channels (256
//   x 32, 512 x 16), and two blocks share an SM, so that one's loads and
//   stores hide behind the other's products.
// - f32 instance: split TF32. A single TF32 product keeps 10 mantissa bits,
//   which the port's f32 accuracy limit forbids, so each operand is split
//   v = hi + lo with hi = tf32(v), lo = tf32(v - hi) (weights at packing
//   time, activations by the producers, two tiles each) and three products
//   hi*lo + lo*hi + hi*hi (small terms first) go into one f32 accumulator
//   with wgmma m64nNk8 TF32: its bound is 3 TF32 products per f32 product.
//   With two tiles of everything a block takes the SM alone: two consumer
//   warpgroups, 128 positions x 128 channels.
// - Tap count and dilation are run-time arguments: 7 kernel instances
//   (three widths in bf16, four in f32), not one per tap count.
// - The epilogue (bias, residual, three store modes, one rounding at the
//   store) goes through shared memory, over the rings, so that global
//   memory sees 16-byte accesses of whole rows: the sums lie in registers
//   two channels at a time, 2 C apart.
// Narrow and odd widths (C % 4 == 0, down to 4) take the same path: K is
// padded to the instruction's depth and N to the tile with zeros, in the
// packed weights and in the shared input tile, and the store masks them.
// The tile sizes, ring depths and shared-memory bytes come from
// wetts_tpu_torch/models/mrf.py:conv_geometry; they are re-derived here and
// a disagreement is cudaErrorInvalidValue.
//
// Still open: fusing a ResBlock1 conv pair or a branch into one launch (the
// activations would stay on the SM), the upsample into the first conv's
// load, a weight tile that serves more rows (sharing it across a cluster of
// two blocks by multicast was tried and lost to the blocks' lockstep), and
// persistent blocks that overlap one tile's epilogue with the next one's
// loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr int kXProducers = 96;      // three warps load the input tile
// 16-byte K slices per chunk (and TF32 part): 64 bf16 or 32 f32 channels
constexpr int kCs = 8;
constexpr int kMaxXStages = 2;
constexpr int kMaxWStages = 4;
constexpr int kBarrierBytes = 8 * 2 * (kMaxXStages + kMaxWStages);
constexpr int kSmemLimit = 232448;   // what one block may use on sm_90

// ---- the activation type --------------------------------------------------

// leaky relu of a bf16 value, rounded to bf16 and widened again
__device__ __forceinline__ float lrelu_bf16(float v, float slope) {
  return v > 0.f ? v : __bfloat162float(__float2bfloat16_rn(v * slope));
}

__device__ __forceinline__ uint32_t lrelu_bf16x2(uint32_t raw, float slope) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  const __nv_bfloat162 r = __floats2bfloat162_rn(lrelu_bf16(f.x, slope),
                                                 lrelu_bf16(f.y, slope));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// v = hi + lo with both parts TF32 values (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

template <typename XT> struct Io;

template <> struct Io<float> {
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <> struct Io<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float2 load2(const T* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store2(T* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// ---- geometry, as wetts_tpu_torch/models/mrf.py:conv_geometry gives it ----

struct Geometry {
  int nt, mt, wgs, rows_p, n_slices, co_p, x_stages, w_stages, tps, smem;
};

inline Geometry derive_geometry(int C, int taps, int dil, bool f32) {
  Geometry g;
  const int eps = f32 ? 4 : 8;  // values per 16-byte slice
  const int parts = f32 ? 2 : 1;
  // bf16: 128 x 64 outputs a block, one consumer warpgroup, two blocks an
  // SM; f32 (two tiles of everything, three products): 128 x 128, two
  // consumer warpgroups, one block an SM. Narrow stages take more rows
  // (bf16 256 x 32 and 512 x 16; f32 256 x 64 and 512 x 32 or 16).
  if (f32) {
    g.nt = C <= 16 ? 16 : C <= 32 ? 32 : C <= 64 ? 64 : 128;
    g.mt = g.nt <= 32 ? 4 : 128 / g.nt;
    g.wgs = 2;
  } else {
    g.nt = C <= 16 ? 16 : C <= 32 ? 32 : 64;
    g.mt = 128 / g.nt;
    g.wgs = 1;
  }
  const int rows = g.wgs * g.mt * 64 + (taps - 1) * dil;
  g.rows_p = (rows + 6) / 8 * 8 + 1;
  g.n_slices = 2 * ((C + 2 * eps - 1) / (2 * eps));
  g.co_p = (C + g.nt - 1) / g.nt * g.nt;
  const int n_chunks = (g.n_slices + kCs - 1) / kCs;
  const int chunk_slices = g.n_slices < kCs ? g.n_slices : kCs;
  g.x_stages = n_chunks < kMaxXStages ? n_chunks : kMaxXStages;
  g.w_stages = f32 ? 3 : kMaxWStages;
  // taps per weight tile: about 16 KB a tile (f32: 32 KB, but 16 KB at 64
  // channels, where the input ring is at its largest)
  const int tps = !f32 || g.nt == 16 ? 128 / g.nt : g.nt == 32 ? 2 : 1;
  g.tps = tps < taps ? tps : taps;
  const int rings = g.x_stages * parts * chunk_slices * g.rows_p * 16
                    + g.w_stages * g.tps * parts * chunk_slices * g.nt * 16;
  // the epilogue's tiles of the output lie over the rings: the residual's
  // and, in bf16, that of the output to accumulate to
  const int tiles = g.wgs * g.mt * 64 * (g.nt + 8) * (f32 ? 4 : 2 * 2);
  g.smem = (rings > tiles ? rings : tiles) + kBarrierBytes;
  return g;
}

// One chunk of the input tile, by the 96 producer threads: rows t_first ..
// t_first + rows of channels ci0 .. ci0 + ns slices, zero outside [0, T) and
// past C, into [slice][row][16 bytes]. Every thread first issues all its
// asynchronous copies (granules of 16 bytes, or of 8 where a bf16 C is no
// multiple of 8), so that the whole chunk is in flight at once, then
// applies the leaky relu (and in f32 the TF32 split into the hi tile and,
// `x_part` bytes on, the lo tile) in place to the granules it copied.
template <typename XT>
__device__ __forceinline__ void stage_input(
    uint8_t* tile, uint32_t x_part, const XT* xb, int ptid, int ns, int ci0,
    int t_first, int rows, int rows_p, int T, int C, float slope) {
  constexpr bool kF32 = std::is_same<XT, float>::value;
  const bool wide = kF32 || C % 8 == 0;
  // granules per row; ns is even, so `gran` divides the 96 threads
  const int gran = wide ? ns : 2 * ns;
  const int g = ptid % gran;
  const int rstep = kXProducers / gran;
  const int r0 = ptid / gran;
  const int ci = ci0 + g * (kF32 || !wide ? 4 : 8);
  uint8_t* dst = tile + (wide ? g * rows_p * 16
                              : (g >> 1) * rows_p * 16 + (g & 1) * 8);
  const uint32_t dst_addr = smem_addr(dst);
  for (int r = r0; r < rows; r += rstep) {
    const int t = t_first + r;
    const bool ok = t >= 0 && t < T && ci < C;
    const XT* src = ok ? xb + (size_t)t * C + ci : xb;
    if (wide) cp_async<16>(dst_addr + r * 16, src, ok);
    else cp_async<8>(dst_addr + r * 16, src, ok);
  }
  cp_async_wait_all();
  if constexpr (kF32) {
#pragma unroll 4
    for (int r = r0; r < rows; r += rstep) {
      const float4 v = *reinterpret_cast<const float4*>(dst + r * 16);
      const float f[4] = {v.x, v.y, v.z, v.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(f[e] >= 0.f ? f[e] : f[e] * slope, hi[e], lo[e]);
      *reinterpret_cast<uint4*>(dst + r * 16) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(dst + x_part + r * 16) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  } else if (wide) {
#pragma unroll 4
    for (int r = r0; r < rows; r += rstep) {
      uint4 v = *reinterpret_cast<const uint4*>(dst + r * 16);
      v.x = lrelu_bf16x2(v.x, slope); v.y = lrelu_bf16x2(v.y, slope);
      v.z = lrelu_bf16x2(v.z, slope); v.w = lrelu_bf16x2(v.w, slope);
      *reinterpret_cast<uint4*>(dst + r * 16) = v;
    }
  } else {
#pragma unroll 4
    for (int r = r0; r < rows; r += rstep) {
      uint2 v = *reinterpret_cast<const uint2*>(dst + r * 16);
      v.x = lrelu_bf16x2(v.x, slope); v.y = lrelu_bf16x2(v.y, slope);
      *reinterpret_cast<uint2*>(dst + r * 16) = v;
    }
  }
}

// ---- the kernel -----------------------------------------------------------

template <typename XT, int NT, int MT, int WGS>
__global__ void __launch_bounds__(WGS * 128 + 128, WGS == 1 ? 2 : 1)
mrf_conv_kernel(const XT* __restrict__ x, const XT* __restrict__ wp,
                const XT* __restrict__ bias, const XT* res, XT* out,
                int T, int C, int taps, int dil, int rows_p, int n_slices,
                int co_p, int x_stages, int w_stages, int tps, int smem_bytes,
                float slope, float scale, int mode) {
  constexpr bool kF32 = std::is_same<XT, float>::value;
  constexpr int kParts = kF32 ? 2 : 1;       // hi and lo tiles in f32
  constexpr int kChunkCh = kCs * 16 / (int)sizeof(XT);
  constexpr int kConsumerWarps = 4 * WGS;
  constexpr int kConsumers = 128 * WGS;
  constexpr int TT = WGS * MT * 64;          // positions per block
  extern __shared__ __align__(128) uint8_t smem[];

  // [stage][part][slice][row][16 B] inputs, then [stage][tap of the group]
  // [part][slice][channel][16 B] weights, then the barriers
  const int chunk_slices = min(kCs, n_slices);
  const uint32_t x_part = chunk_slices * rows_p * 16;
  const uint32_t x_stage = kParts * x_part;
  const uint32_t w_part = chunk_slices * NT * 16;
  const uint32_t w_tap = kParts * w_part;
  const uint32_t w_stage = tps * w_tap;
  uint8_t* x_ring = smem;
  uint8_t* w_ring = smem + x_stages * x_stage;
  const uint32_t bars = smem_addr(smem + smem_bytes - kBarrierBytes);
  const uint32_t x_full = bars, x_empty = bars + 8 * kMaxXStages;
  const uint32_t w_full = bars + 16 * kMaxXStages;
  const uint32_t w_empty = w_full + 8 * kMaxWStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * TT;
  const int co0 = blockIdx.y * NT;
  const int halo = (taps - 1) * dil;
  const int rows = TT + halo;
  const int n_chunks = (n_slices + kCs - 1) / kCs;

  if (threadIdx.x == 0) {
    for (int i = 0; i < x_stages; ++i) {
      mbar_init(x_full + 8 * i, kXProducers);
      mbar_init(x_empty + 8 * i, kConsumerWarps);
    }
    for (int i = 0; i < w_stages; ++i) {
      mbar_init(w_full + 8 * i, 1);
      mbar_init(w_empty + 8 * i, kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    if (warp == kConsumerWarps) {
      // ---- weight producer: one warp streams the tiles of (chunk, group
      // of `tps` taps), one bulk copy per (tap, part, slice) ----
      int slot = 0;
      uint32_t parity = 1;  // a fresh slot is free
      for (int c = 0; c < n_chunks; ++c) {
        const int ns = min(kCs, n_slices - c * kCs);
        for (int tap0 = 0; tap0 < taps; tap0 += tps) {
          const int n_copies = min(tps, taps - tap0) * kParts * ns;
          mbar_wait(w_empty + 8 * slot, parity);
          if (lane == 0)
            mbar_arrive_expect_tx(w_full + 8 * slot, n_copies * NT * 16);
          __syncwarp();
          for (int i = lane; i < n_copies; i += 32) {
            const int s = i % ns, part = (i / ns) % kParts;
            const int tg = i / (ns * kParts);
            const size_t row =
                ((size_t)(part * taps + tap0 + tg) * n_slices + c * kCs + s)
                    * co_p + co0;
            bulk_copy(smem_addr(w_ring + slot * w_stage + tg * w_tap
                                + part * w_part + s * NT * 16),
                      reinterpret_cast<const uint8_t*>(wp) + row * 16,
                      NT * 16, w_full + 8 * slot);
          }
          if (++slot == w_stages) { slot = 0; parity ^= 1; }
        }
      }
    } else {
      // ---- input producers: rows t0 - pad .. t0 + TT + halo - pad of one
      // chunk of channels, zero outside [0, T) and past C, leaky relu
      // applied, stored as [slice][row][16 bytes] ----
      const int ptid = threadIdx.x - (kConsumerWarps + 1) * 32;
      const int pad = halo / 2;
      const XT* xb = x + (size_t)b * T * C;
      for (int c = 0; c < n_chunks; ++c) {
        const int slot = c % x_stages;
        mbar_wait(x_empty + 8 * slot, ((c / x_stages) & 1) ^ 1);
        const int ns = min(kCs, n_slices - c * kCs);
        stage_input<XT>(x_ring + slot * x_stage, x_part, xb, ptid, ns,
                        c * kChunkCh, t0 - pad, rows, rows_p, T, C, slope);
        // the stores above are read by the tensor cores' asynchronous proxy
        fence_proxy_async();
        mbar_arrive(x_full + 8 * slot);
      }
    }
  } else {
    // ---- the consumer warpgroups: MT 64-row tiles each ----
    const int row0 = (warp / 4) * MT * 64;
    float acc[MT][NT / 2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[m][i] = 0.f;

    int slot = 0, prev_slot = 0, prev_xs = 0;
    uint32_t parity = 0;
    bool first = true;
    for (int c = 0; c < n_chunks; ++c) {
      const int xs = c % x_stages;
      mbar_wait(x_full + 8 * xs, (c / x_stages) & 1);
      const int nk = min(kCs, n_slices - c * kCs) / 2;
      const uint32_t xbase = smem_addr(x_ring + xs * x_stage);
      for (int tap0 = 0; tap0 < taps; tap0 += tps) {
        mbar_wait(w_full + 8 * slot, parity);
        const uint32_t wbase = smem_addr(w_ring + slot * w_stage);
#pragma unroll
        for (int m = 0; m < MT; ++m) fence_sums(acc[m]);
        wgmma_fence();
        const int n_taps = min(tps, taps - tap0);
        for (int tg = 0; tg < n_taps; ++tg) {
          for (int ks = 0; ks < nk; ++ks) {
            // the tap's shift is a change of the start address by whole rows
            const uint32_t a0 =
                xbase + (2 * ks * rows_p + row0 + (tap0 + tg) * dil) * 16;
            const uint32_t b0 = wbase + tg * w_tap + 2 * ks * NT * 16;
            const uint64_t db = operand_desc(b0, NT * 16, 128);
            if constexpr (kF32) {
              const uint64_t db_lo = operand_desc(b0 + w_part, NT * 16, 128);
#pragma unroll
              for (int m = 0; m < MT; ++m) {
                const uint64_t da =
                    operand_desc(a0 + m * 64 * 16, rows_p * 16, 128);
                const uint64_t da_lo =
                    operand_desc(a0 + x_part + m * 64 * 16, rows_p * 16, 128);
                Wgmma<NT>::tf32(acc[m], da, db_lo);
                Wgmma<NT>::tf32(acc[m], da_lo, db);
                Wgmma<NT>::tf32(acc[m], da, db);
              }
            } else {
#pragma unroll
              for (int m = 0; m < MT; ++m)
                Wgmma<NT>::bf16(
                    acc[m], operand_desc(a0 + m * 64 * 16, rows_p * 16, 128),
                    db);
            }
          }
        }
        wgmma_commit();
        if (!first) {
          // the products of the group before are done: hand its weight
          // stage and, at a chunk's first group, the chunk before back
          wgmma_wait<1>();
          if (lane == 0) {
            mbar_arrive(w_empty + 8 * prev_slot);
            if (tap0 == 0) mbar_arrive(x_empty + 8 * prev_xs);
          }
        }
        first = false;
        prev_slot = slot;
        if (++slot == w_stages) { slot = 0; parity ^= 1; }
      }
      prev_xs = xs;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_sums(acc[m]);

    // epilogue: bias, residual, then store / store-scaled / accumulate-
    // scaled, through shared memory so that global memory sees whole rows:
    // a thread holds rows lane / 4 and + 8 of its warp's 16 in each 64-row
    // tile and the channel pairs 8 j + 2 (lane % 4), which would be 4-byte
    // accesses 2 C apart. The rings are free now (every copy has landed and
    // every product is done), so (a) the residual tile and, to accumulate
    // in bf16, the output's tile come in by 16-byte asynchronous copies,
    // all in flight at once; (b) each thread folds its sums into the
    // residual tile's elements, which it alone touches; (c) the tile goes
    // out in 16-byte stores (f32 accumulates here, where it rounds the
    // same; bf16 must add before its one rounding in (b)). Rows are padded
    // by 8 values, which keeps the accesses of (b) off bank conflicts.
    constexpr int kPairs = MT * 2 * (NT / 8);
    constexpr uint32_t kRow = (NT + 8) * sizeof(XT);
    const int tid = threadIdx.x;
    uint8_t* tile_r = smem;
    uint8_t* tile_o = smem + TT * kRow;
    const bool wide = kF32 || C % 8 == 0;
    const int gb = wide ? 16 : 8;                   // bytes per granule
    const int gch = gb / (int)sizeof(XT);           // channels per granule
    const int gpr = NT / gch;                       // granules per row
    const size_t base0 = ((size_t)b * T + t0) * C + co0;
    const bool stage_out = !kF32 && mode == 2;
    consumer_barrier<kConsumers>();  // the other warpgroup's products too
    if (res != nullptr || stage_out) {
      for (int i = tid; i < TT * gpr; i += kConsumers) {
        const int row = i / gpr, g = i - row * gpr;
        const bool ok = t0 + row < T && co0 + g * gch < C;
        const size_t at = ok ? base0 + (size_t)row * C + g * gch : 0;
        const uint32_t off = row * kRow + g * gb;
        if (res != nullptr) {
          if (wide) cp_async<16>(smem_addr(tile_r + off), res + at, ok);
          else cp_async<8>(smem_addr(tile_r + off), res + at, ok);
        }
        if (stage_out) {
          if (wide) cp_async<16>(smem_addr(tile_o + off), out + at, ok);
          else cp_async<8>(smem_addr(tile_o + off), out + at, ok);
        }
      }
      cp_async_wait_all();
    }
    consumer_barrier<kConsumers>();
    const int lr = row0 + (warp % 4) * 16 + lane / 4;
    const int lc = (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int m = i / (NT / 4), h = (i / (NT / 8)) % 2, j = i % (NT / 8);
      const int col = lc + 8 * j;
      const uint32_t off = (lr + m * 64 + h * 8) * kRow + col * sizeof(XT);
      float v0 = acc[m][4 * j + 2 * h], v1 = acc[m][4 * j + 2 * h + 1];
      if (co0 + col < C) {
        const float2 bv = Io<XT>::load2(bias + co0 + col);
        v0 += bv.x; v1 += bv.y;
      }
      if (res != nullptr) {
        const float2 r =
            Io<XT>::load2(reinterpret_cast<const XT*>(tile_r + off));
        v0 += r.x; v1 += r.y;
      }
      if (mode != 0) {
        v0 *= scale; v1 *= scale;
      }
      if (stage_out) {
        const float2 p =
            Io<XT>::load2(reinterpret_cast<const XT*>(tile_o + off));
        v0 += p.x; v1 += p.y;
      }
      Io<XT>::store2(reinterpret_cast<XT*>(tile_r + off), v0, v1);
    }
    consumer_barrier<kConsumers>();
    for (int i = tid; i < TT * gpr; i += kConsumers) {
      const int row = i / gpr, g = i - row * gpr;
      if (t0 + row >= T || co0 + g * gch >= C) continue;
      XT* dst = out + base0 + (size_t)row * C + g * gch;
      const uint8_t* src = tile_r + row * kRow + g * gb;
      if constexpr (kF32) {
        float4 v = *reinterpret_cast<const float4*>(src);
        if (mode == 2) {
          const float4 p = *reinterpret_cast<const float4*>(dst);
          v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
        }
        *reinterpret_cast<float4*>(dst) = v;
      } else if (wide) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      }
    }
  }
}

template <typename XT, int NT, int MT, int WGS>
cudaError_t launch(const XT* x, const XT* wp, const XT* bias, const XT* res,
                   XT* out, int B, int T, int C, int taps, int dil,
                   const Geometry& g, float slope, float scale, int mode,
                   cudaStream_t stream) {
  // once per instance and device: above 48 KB an instance must be allowed
  // more dynamic shared memory (it is allowed the device's whole opt-in
  // size; the allowance is a ceiling, occupancy follows each launch's own
  // size), and the SM is asked for its largest shared-memory carve-out, so
  // that two blocks fit wherever their sizes allow it
  static std::atomic<bool> prepared[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  e = allow_shared_memory(mrf_conv_kernel<XT, NT, MT, WGS>, dev, prepared);
  if (e != cudaSuccess) return e;
  const int tt = WGS * MT * 64;
  const dim3 grid((T + tt - 1) / tt, g.co_p / NT, B);
  mrf_conv_kernel<XT, NT, MT, WGS><<<grid, WGS * 128 + 128, g.smem, stream>>>(
      x, wp, bias, res, out, T, C, taps, dil, g.rows_p, g.n_slices, g.co_p,
      g.x_stages, g.w_stages, g.tps, g.smem, slope, scale, mode);
  return cudaGetLastError();
}

template <typename XT>
int mrf_conv(const void* x, const void* wp, const void* bias, const void* res,
             void* out, int B, int T, int C, int K, int dil, float slope,
             float scale, int mode, const int* geometry, void* stream) {
  constexpr bool kF32 = std::is_same<XT, float>::value;
  if (B <= 0 || T <= 0 || C <= 0 || C % 4 != 0 || K < 1 || K % 2 == 0
      || dil < 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const Geometry g = derive_geometry(C, K, dil, kF32);
  const int mine[10] = {g.nt, g.mt, g.wgs, g.rows_p, g.n_slices, g.co_p,
                        g.x_stages, g.w_stages, g.tps, g.smem};
  for (int i = 0; i < 10; ++i)
    if (geometry[i] != mine[i]) return (int)cudaErrorInvalidValue;
  if (g.smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const XT* xp = static_cast<const XT*>(x);
  const XT* wpp = static_cast<const XT*>(wp);
  const XT* bp = static_cast<const XT*>(bias);
  const XT* rp = static_cast<const XT*>(res);
  XT* op = static_cast<XT*>(out);
#define MRF_TILE(nt, mt, wgs)                                                \
  case nt:                                                                   \
    return (int)launch<XT, nt, mt, wgs>(xp, wpp, bp, rp, op, B, T, C, K, dil, \
                                        g, slope, scale, mode, s);
  if constexpr (kF32) {
    switch (g.nt) {
      MRF_TILE(16, 4, 2) MRF_TILE(32, 4, 2) MRF_TILE(64, 2, 2)
      MRF_TILE(128, 1, 2)
    }
  } else {
    switch (g.nt) { MRF_TILE(16, 8, 1) MRF_TILE(32, 4, 1) MRF_TILE(64, 2, 1) }
  }
  return (int)cudaErrorInvalidValue;
#undef MRF_TILE
}

}  // namespace

// x, res, out: [B, T, C] contiguous (res may be null, out may be res); wp:
// the weights packed by wetts_tpu_torch/models/mrf.py:pack_weight,
// [tap][slice][C_out padded][16 bytes], for f32 the TF32 hi parts then the
// lo parts; bias: [C]; K odd; all f32 (mrf_conv_f32) or all bf16
// (mrf_conv_bf16). mode 0: out = v; 1: out = scale * v; 2: out += scale * v.
// geometry: the 10 ints of conv_geometry (nt, mt, wgs, rows_p, n_slices,
// co_p, x_stages, w_stages, taps per weight stage, smem_bytes). Launches on
// `stream` and returns the launch's cudaError_t.
extern "C" int mrf_conv_f32(const void* x, const void* wp, const void* bias,
                            const void* res, void* out, int B, int T, int C,
                            int K, int dil, float slope, float scale, int mode,
                            const int* geometry, void* stream) {
  return mrf_conv<float>(x, wp, bias, res, out, B, T, C, K, dil, slope, scale,
                         mode, geometry, stream);
}

extern "C" int mrf_conv_bf16(const void* x, const void* wp, const void* bias,
                             const void* res, void* out, int B, int T, int C,
                             int K, int dil, float slope, float scale,
                             int mode, const int* geometry, void* stream) {
  return mrf_conv<__nv_bfloat16>(x, wp, bias, res, out, B, T, C, K, dil, slope,
                                 scale, mode, geometry, stream);
}
