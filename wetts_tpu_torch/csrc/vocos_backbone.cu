// The Vocos decoder's backbone on Hopper: its 1x1 convs as GEMMs on the
// tensor cores with the elementwise work in their epilogues, and a row kernel
// for the depthwise conv and the LayerNorms.
//
// Replaces no TPU kernel: the JAX package leaves the backbone
// (wetts_tpu/models/vocos.py) to XLA. The port's module path runs it as
// cuDNN f32 convs (TF32 off) on the CUDA cores, with a transpose around
// every LayerNorm; this file is its inference path on the card. The wrapper
// is wetts_tpu_torch/models/vocos_backbone.py; activations are channels
// last, [rows x frames, C], so that both operands of every product are
// K-major, as tf32 wgmma needs (it cannot read a transposed operand):
//
//   vocos_gemm:    out[m, n] = epi(sum_k x[m, k] * w[n, k])
//     mode 0 (bias):     acc + bias[n] (+ row_vec[m / t1, n] where given:
//                        the in_conv with the speaker's cond(g))
//     mode 1 (gelu):     gelu_erf(acc + bias[n])          (pw_conv1)
//     mode 2 (residual): res[m, n] + scale[n] * (acc + bias[n])  (pw_conv2,
//                        in place on the residual stream)
//   vocos_rownorm: y[m] = layer_norm(dwconv3(x)[m]) over C (eps given), the
//                  conv zero-padded inside each row of frames, so that no
//                  row reads its neighbour's; without conv weights the
//                  LayerNorm alone (norm_pre, norm_post)
//
// What bounds it: arithmetic. At the benchmark's 8 rows of 1153 frames the
// backbone does 244 GFLOP against about 100 MB, far above either ridge. f32
// accuracy forbids a single TF32 product (10 mantissa bits), so every
// operand is split v = hi + lo into TF32 parts and three products
// hi*lo + lo*hi + hi*hi are taken, as K1 (mrf_stage.cu) does: the bound is
// 3 TF32 products per f32 product, 165 TFLOP/s of f32 work. The design:
// - A split accumulator: each stage's 12 products (32 values of K) go into
//   a fresh f32 tile on the tensor cores, which the CUDA cores add into
//   the running sums. The tensor cores' additions truncate toward zero
//   where FFMA rounds to nearest: summed there over all of K, the gap to
//   float64 grew with K and leant toward zero (2.3e-5 of the largest
//   magnitude at K = 3072, 1.2e-5 at pw_conv2's 1536, against cuBLAS f32's
//   4-7e-7); with a sum per stage it stays at 3-6e-7 for any K, for some
//   4% of the GEMMs' time (PERF.md).
// - Block tile 128 rows x 128 output channels: two consumer warpgroups of
//   64 rows (wgmma m64n128k8 tf32) and a producer warpgroup, whose first
//   warp streams the weights and whose other three the activations.
// - The activations' A operand comes from registers: each consumer thread
//   reads its rows' values of a stage from shared memory, splits them into
//   TF32 hi and lo in registers, and gives them to wgmma as fragments. So
//   the activation tile stays f32 in shared memory (16 KB a stage), and no
//   producer splits anything before a stage can be used. Split by the
//   producer warps in shared memory and read from there (as K1 does), the
//   same GEMMs ran at 42-48 TFLOP/s on an H100 (700 W), the split on the
//   stage's critical path; from registers at 71-74 (PERF.md). The weights
//   are split ahead for the same reason: shipped in f32 and split by the
//   producers as they land (half the bytes from L2), they ran at 48-56.
// - The weights are split once, when they are packed (models/
//   vocos_backbone.py:pack_weight), as [N tile][32-value K chunk][part][128
//   channels][128 bytes], K-major under the 128-byte swizzle (16-byte chunk
//   j of row r stored at j ^ (r % 8), which wgmma reads without bank
//   conflicts), with K inside a chunk in the order of the fragments: a
//   stage's hi and lo tiles are one bulk copy (cp.async.bulk) completing on
//   the stage's mbarrier.
// - Activations come by 16-byte cp.async (eight threads a row, zeros past
//   M and K) into the same swizzle, which keeps the consumers' 16-byte reads
//   conflict-free; each producer thread's arrival is tied to its copies'
//   completion (cp.async.mbarrier.arrive), so the producers run up to the
//   ring's four stages (192 KB) ahead without waiting.
// - The epilogue goes through shared memory over the ring, so that global
//   memory sees 16-byte accesses of whole rows; the residual tile comes in
//   before any store, so the residual may be the output.
// Ragged M, N and K are masked: M = rows x frames is any size; N is padded
// to the tile in the packed weights and stored up to the next multiple of 4
// (the output's row stride `ldo` is a multiple of 4, so the out_conv's 1026
// channels go to rows of 1028).
//
// Still open: a persistent grid (the last wave of pw_conv2's 292 tiles
// holds 28), and fewer bytes from L2 a product (the pre-split weights are
// twice their f32 size; a tile of 128 x 128 reads both operands anew).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr int kBM = 128;                  // rows of a block
constexpr int kBN = 128;                  // output channels of a block
constexpr int kConsumerWarps = 8;         // two warpgroups of 64 rows
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kAProducers = 96;           // three warps stage activations
constexpr int kThreads = kConsumers + 128;
constexpr int kKStage = 32;               // K values a stage: 128-byte rows
constexpr int kEpiRow = (kBN + 8) * 4;    // bytes of an epilogue tile row
constexpr int kStages = 4;
constexpr int kAPart = kBM * 128;         // the activations' f32 tile
constexpr int kBPart = kBN * 128;         // one TF32 part of the weights'
constexpr int kStage = kAPart + 2 * kBPart;
constexpr int kBarriers = kStages * kStage;
constexpr int kSmem = kBarriers + 16 * kStages;
static_assert(kSmem <= 232448, "the ring exceeds a block's shared memory");
static_assert(kBM * kEpiRow <= kBarriers, "the epilogue tile exceeds the ring");

enum Mode { kBias = 0, kGelu = 1, kResidual = 2 };

// 16 bytes global -> shared through L2 only; `valid` false writes zeros
__device__ __forceinline__ void cp_async_cg16(uint32_t dst, const void* src,
                                              bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// an arrival on `bar` once every cp.async this thread issued has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// d[64 x 128] += a[64 x 8] * b[128 x 8]^T in TF32, a from registers: a
// thread of the warpgroup holds rows lane / 4 (a[0], a[2]) and + 8 (a[1],
// a[3]) of its warp's 16, columns lane % 4 (a[0], a[1]) and + 4 (a[2],
// a[3]); b from shared memory
// (scale_d 0: d = a * b^T, the sums in d dropped)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{" HOPPER_REGS_64 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : HOPPER_ACC_64("+f", d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// exact GELU, as PyTorch computes it in f32
__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.f + erff(v * 0.70710678118654752440f));
}

// byte offset of 16-byte chunk j of row r in a K-major tile of 128-byte
// rows under the 128-byte swizzle: 8-row atoms of 1024 bytes, chunk j of
// row r stored at j ^ (r % 8), as wgmma's swizzle mode 1 reads it
__device__ __forceinline__ uint32_t swizzled(int r, int j) {
  return r * 128 + ((j ^ (r & 7)) << 4);
}

// wgmma descriptor of a K-major operand under the 128-byte swizzle: atoms
// 1024 bytes apart; a step of 8 TF32 values along K adds 32 bytes to the
// start address
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return operand_desc(addr, 16, 1024) | (1ull << 62);
}

__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ wp,
            const float* __restrict__ bias, const float* __restrict__ aux,
            const float* res, float* out, int M, int N, int K, int ldo,
            int t1, int mode) {
  // the swizzle is of address bits: the ring's atoms lie on 1024 bytes
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = smem_addr(smem + kBarriers);
  const uint32_t empty = full + 8 * kStages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int nk = (K + kKStage - 1) / kKStage;  // stages of the K loop

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      // the activation producers' copies and the weights' expect_tx
      mbar_init(full + 8 * i, kAProducers + 1);
      mbar_init(empty + 8 * i, kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    if (warp == kConsumerWarps) {
      // ---- weight producer: a stage's hi and lo tiles, one bulk copy
      if (lane == 0) {
        const uint8_t* wb = reinterpret_cast<const uint8_t*>(wp)
                            + (size_t)blockIdx.x * nk * 2 * kBPart;
        for (int c = 0; c < nk; ++c) {
          const int s = c % kStages;
          mbar_wait(empty + 8 * s, ((c / kStages) & 1) ^ 1, 32);
          mbar_arrive_expect_tx(full + 8 * s, 2 * kBPart);
          bulk_copy(ring + s * kStage + kAPart, wb + (size_t)c * 2 * kBPart,
                    2 * kBPart, full + 8 * s);
        }
      }
    } else {
      // ---- activation producers: rows m0 .. m0 + 128 of a stage's 32 K
      // values in f32, zeros past M and K, eight threads a row, one
      // 16-byte chunk each; each thread's arrival comes when its copies
      // have landed, so it runs on to the next stage at once
      const int ptid = threadIdx.x - kConsumers - 32;
      const int j = ptid % 8;
      constexpr int kStep = kAProducers / 8;
      for (int c = 0; c < nk; ++c) {
        const int s = c % kStages;
        mbar_wait(empty + 8 * s, ((c / kStages) & 1) ^ 1, 32);
        const int k = c * kKStage + 4 * j;
        const uint32_t dst = ring + s * kStage;
        for (int r = ptid / 8; r < kBM; r += kStep) {
          const bool ok = m0 + r < M && k < K;
          cp_async_cg16(dst + swizzled(r, j),
                        ok ? a + (size_t)(m0 + r) * K + k : a, ok);
        }
        cp_async_arrive(full + 8 * s);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: 64 rows x 128 channels each. A thread
  // reads its rows' activations from the stage (rows r and r + 8, the 32
  // bytes of K at 32 (lane % 4)), splits them into TF32 hi and lo in
  // registers and gives them to wgmma as its A fragments; the weights'
  // columns are packed in the matching order ----
  const int wg = warp / 4;
  const int q = lane % 4;
  const int row = wg * 64 + (warp % 4) * 16 + lane / 4;
  // `part` takes a stage's products on the tensor cores, `acc` sums the
  // stages on the CUDA cores (see the note at the top)
  float acc[kBN / 2], part[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = part[i] = 0.f;
  for (int c = 0; c < nk; ++c) {
    const int s = c % kStages;
    mbar_wait(full + 8 * s, (c / kStages) & 1);
    const uint8_t* tile = smem + s * kStage;
    float v[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 x0 = *reinterpret_cast<const float4*>(
          tile + swizzled(row + 8 * h, 2 * q));
      const float4 x1 = *reinterpret_cast<const float4*>(
          tile + swizzled(row + 8 * h, 2 * q + 1));
      v[h][0] = x0.x; v[h][1] = x0.y; v[h][2] = x0.z; v[h][3] = x0.w;
      v[h][4] = x1.x; v[h][5] = x1.y; v[h][6] = x1.z; v[h][7] = x1.w;
    }
    // K step t takes this thread's values 2 t (column q) and 2 t + 1
    // (column q + 4) of each row
    uint32_t hi[kKStage / 8][4], lo[kKStage / 8][4];
#pragma unroll
    for (int t = 0; t < kKStage / 8; ++t) {
      split_tf32(v[0][2 * t], hi[t][0], lo[t][0]);
      split_tf32(v[1][2 * t], hi[t][1], lo[t][1]);
      split_tf32(v[0][2 * t + 1], hi[t][2], lo[t][2]);
      split_tf32(v[1][2 * t + 1], hi[t][3], lo[t][3]);
    }
    const uint32_t bbase = ring + s * kStage + kAPart;
    fence_sums(part);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kKStage / 8; ++t) {
      const uint64_t db = sw128_desc(bbase + 32 * t);
      const uint64_t db_lo = sw128_desc(bbase + kBPart + 32 * t);
      // small terms first; the stage's first product starts `part` anew
      wgmma_tf32_rs(part, hi[t], db_lo, t == 0 ? 0 : 1);
      wgmma_tf32_rs(part, lo[t], db, 1);
      wgmma_tf32_rs(part, hi[t], db, 1);
    }
    wgmma_commit();
    // the registers of this stage's fragments are reused by the next: wait
    // for the products (the other warpgroup's keep the tensor cores busy
    // meanwhile; two sets of fragments in turn measured no faster), then
    // hand the stage back
    wgmma_wait<0>();
    fence_sums(part);
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] += part[i];
#pragma unroll
    for (int t = 0; t < kKStage / 8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        asm volatile("" : "+r"(hi[t][i]), "+r"(lo[t][i]) :: "memory");
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // ---- epilogue through shared memory: (a) the residual tile comes in by
  // 16-byte copies, (b) each thread folds its sums into its own elements,
  // (c) the tile goes out in 16-byte stores of whole rows ----
  uint8_t* tile = smem;
  const int tid = threadIdx.x;
  constexpr int kGpr = kBN / 4;  // 16-byte granules a tile row
  consumer_barrier<kConsumers>();  // both warpgroups are done with the ring
  if (mode == kResidual) {
    for (int i = tid; i < kBM * kGpr; i += kConsumers) {
      const int row = i / kGpr, g = i % kGpr;
      const bool ok = m0 + row < M && n0 + 4 * g < N;
      cp_async<16>(smem_addr(tile + row * kEpiRow + g * 16),
                   ok ? res + (size_t)(m0 + row) * ldo + n0 + 4 * g : res,
                   ok);
    }
    cp_async_wait_all();
  }
  consumer_barrier<kConsumers>();
  const int lr = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int lc = (lane % 4) * 2;
#pragma unroll
  for (int i = 0; i < kBN / 4; ++i) {
    const int j = i / 2, h = i % 2;
    const int row = lr + 8 * h, col = lc + 8 * j;
    const int m = m0 + row;
    float* at = reinterpret_cast<float*>(tile + row * kEpiRow + col * 4);
    float v[2] = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + col + e;
      if (n >= N) {
        v[e] = 0.f;
        continue;
      }
      float x = v[e] + bias[n];
      if (mode == kGelu) {
        x = gelu_erf(x);
      } else if (mode == kResidual) {
        x = at[e] + aux[n] * x;
      } else if (aux != nullptr && m < M) {
        x += aux[(size_t)(m / t1) * N + n];
      }
      v[e] = x;
    }
    *reinterpret_cast<float2*>(at) = make_float2(v[0], v[1]);
  }
  consumer_barrier<kConsumers>();
  for (int i = tid; i < kBM * kGpr; i += kConsumers) {
    const int row = i / kGpr, g = i % kGpr;
    if (m0 + row >= M || n0 + 4 * g >= N) continue;
    *reinterpret_cast<float4*>(out + (size_t)(m0 + row) * ldo + n0 + 4 * g) =
        *reinterpret_cast<const float4*>(tile + row * kEpiRow + g * 16);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp a row of C channels, VPL 4-channel granules a lane: the depthwise
// conv of 3 taps over the row's neighbours in time (zeros outside the row of
// frames) plus its bias where `dw_w` is given, then LayerNorm.
template <int VPL>
__global__ void __launch_bounds__(256)
rownorm_kernel(const float* __restrict__ x, float* __restrict__ y,
               const float* __restrict__ dw_w, const float* __restrict__ dw_b,
               const float* __restrict__ gamma,
               const float* __restrict__ beta, int M, int t1, int C,
               float eps) {
  const int m = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;
  const int t = m % t1;
  const bool prev = t > 0, next = t + 1 < t1;
  const float* xr = x + (size_t)m * C;
  float v[VPL][4];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = 4 * (lane + 32 * i);
    if (c >= C) {
      v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
      continue;
    }
    const float4 xc = *reinterpret_cast<const float4*>(xr + c);
    float f[4] = {xc.x, xc.y, xc.z, xc.w};
    if (dw_w != nullptr) {
      const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 xp = prev ? *reinterpret_cast<const float4*>(xr - C + c)
                             : z4;
      const float4 xn = next ? *reinterpret_cast<const float4*>(xr + C + c)
                             : z4;
      const float p[4] = {xp.x, xp.y, xp.z, xp.w};
      const float q[4] = {xn.x, xn.y, xn.z, xn.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* w = dw_w + 3 * (c + e);
        f[e] = fmaf(w[2], q[e], fmaf(w[1], f[e], w[0] * p[e])) + dw_b[c + e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[i][e] = f[e];
      sum += f[e];
    }
  }
  const float mean = warp_sum(sum) / C;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (4 * (lane + 32 * i) >= C) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = v[i][e] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / C + eps);
  float* yr = y + (size_t)m * C;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = 4 * (lane + 32 * i);
    if (c >= C) continue;
    const float4 gm = *reinterpret_cast<const float4*>(gamma + c);
    const float4 bt = *reinterpret_cast<const float4*>(beta + c);
    *reinterpret_cast<float4*>(yr + c) = make_float4(
        (v[i][0] - mean) * rstd * gm.x + bt.x,
        (v[i][1] - mean) * rstd * gm.y + bt.y,
        (v[i][2] - mean) * rstd * gm.z + bt.z,
        (v[i][3] - mean) * rstd * gm.w + bt.w);
  }
}

}  // namespace

// a [M, K] and out [M, ldo] f32, contiguous; wp the weights packed by
// wetts_tpu_torch/models/vocos_backbone.py:pack_weight; bias [N]; aux: mode
// 0 a [M / t1, N] row vector or null, mode 1 unused, mode 2 the scale [N];
// res [M, ldo] (mode 2 only; may be out). K % 4 == 0, ldo % 4 == 0 and
// ldo >= N, N % 4 == 0 in mode 2. Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int vocos_gemm(const void* a, const void* wp, const void* bias,
                          const void* aux, const void* res, void* out, int M,
                          int N, int K, int ldo, int t1, int mode,
                          void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0 || ldo % 4 != 0 || ldo < N
      || t1 <= 0 || mode < kBias || mode > kResidual
      || (mode == kResidual && (N % 4 != 0 || res == nullptr
                                || aux == nullptr)))
    return (int)cudaErrorInvalidValue;
  static std::atomic<bool> prepared[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  e = allow_shared_memory(gemm_kernel, dev, prepared);
  if (e != cudaSuccess) return (int)e;
  // N tiles fastest: the blocks in flight share their rows of `a`
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(wp),
      static_cast<const float*>(bias), static_cast<const float*>(aux),
      static_cast<const float*>(res), static_cast<float*>(out), M, N, K, ldo,
      t1, mode);
  return (int)cudaGetLastError();
}

// x, y [M, C] f32 contiguous and distinct, rows of t1 frames; dw_w [C, 3]
// and dw_b [C] or both null; gamma, beta [C]. C % 4 == 0, C <= 1024.
extern "C" int vocos_rownorm(const void* x, void* y, const void* dw_w,
                             const void* dw_b, const void* gamma,
                             const void* beta, int M, int t1, int C, float eps,
                             void* stream) {
  if (M <= 0 || t1 <= 0 || C <= 0 || C % 4 != 0 || C > 1024 || x == y
      || (dw_w == nullptr) != (dw_b == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  const float* wp = static_cast<const float*>(dw_w);
  const float* bp = static_cast<const float*>(dw_b);
  const float* gp = static_cast<const float*>(gamma);
  const float* tp = static_cast<const float*>(beta);
  const dim3 grid((M + 7) / 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vpl = (C + 127) / 128;
  if (vpl <= 1)
    rownorm_kernel<1><<<grid, 256, 0, s>>>(xp, yp, wp, bp, gp, tp, M, t1, C,
                                           eps);
  else if (vpl <= 2)
    rownorm_kernel<2><<<grid, 256, 0, s>>>(xp, yp, wp, bp, gp, tp, M, t1, C,
                                           eps);
  else if (vpl <= 4)
    rownorm_kernel<4><<<grid, 256, 0, s>>>(xp, yp, wp, bp, gp, tp, M, t1, C,
                                           eps);
  else
    rownorm_kernel<8><<<grid, 256, 0, s>>>(xp, yp, wp, bp, gp, tp, M, t1, C,
                                           eps);
  return (int)cudaGetLastError();
}
