// K3: a chain of dependent matrix products with a requantisation between
// them, a <- requant(a @ w), `hops` times, in int8 and in bf16.
//
// Replaces tools/probe_int8_mxu.py:_chain, the Pallas TPU kernel that the
// JAX package wrote to measure whether int8 products on the matrix unit
// beat bf16 ones (grid over 512-row tiles of a, each tile and w whole in
// VMEM). The wrapper is wetts_tpu_torch/ops/int8_chain.py:matmul_chain.
//
//   int8: y = a @ w in int32;  a <- clip(y >> 10, -127, 127)  (arithmetic)
//   bf16: y = a @ w in f32;    a <- bf16(y * (1 / 32))
//
// a: [M, K], w: [K, K].
//
// What bounds it: operations, 2 M K K per hop on the tensor cores (0.278 ms
// in bf16, 0.139 in int8 for the probe's 16 hops of [8192, 1024] x [1024,
// 1024] on an H100). The TPU kernel keeps a 512-row tile of a and all of w
// in VMEM across the hops; Hopper's 227 KB of shared memory holds a 64-row
// int8 tile twice and no w, so a block that keeps its rows on chip must
// stream all of w on every hop, and 128-256 such blocks read 2-9 GB of w
// from L2 per chain: that, and not the tensor cores, set the pace of the
// first design (one launch, mma.sync). This design runs the chain hop by
// hop, each hop a full-card GEMM with large tiles:
// - one launch per hop; a block computes a 256 x 128 tile of the hop's
//   output (two consumer warpgroups of 128 rows, each two wgmma m64n128
//   per K step: k32 s8 -> s32 or k16 bf16 -> f32), so w is read from L2
//   M / 256 times per hop: 0.5 GB per int8 chain and 1 GB per bf16 chain
//   at the probe's shapes, against 2.1 and 8.6 GB before;
// - the operands live in device memory in the layout the tensor cores
//   read, [row tile][128-byte K block][16-byte slice][row][16 bytes]
//   (no swizzle, K-major), so that each K block of a row tile (32 KB of a,
//   16 KB of w) is one contiguous bulk asynchronous copy (cp.async.bulk)
//   that completes on an mbarrier; one producer warp keeps a ring of four
//   such stages in flight while the consumers multiply;
// - the requantisation is the epilogue: the sums are requantised in
//   registers, laid out in shared memory and stored as 16-byte rows, in
//   the blocked layout for the next hop or, after the last hop, as the
//   row-major [M, K] result. The hop's input and output ping-pong between
//   two buffers (16 MB each in bf16) that stay in the 50 MB L2.
// The wrapper packs a and w into the blocked layout (a PyTorch copy) and
// hands over M padded to the row tile; rows past M are zeros and stay so.
// K must be a multiple of 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr int kBM = 256;             // rows of a block's output tile
constexpr int kBN = 128;             // columns of a block's output tile
constexpr int kSlices = 8;           // 16-byte slices of a 128-byte K block
constexpr int kStages = 4;
constexpr int kConsumers = 256;      // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr uint32_t kABytes = kSlices * kBM * 16;  // 32 KB
constexpr uint32_t kBBytes = kSlices * kBN * 16;  // 16 KB
constexpr uint32_t kStageBytes = kABytes + kBBytes;
constexpr int kSmem = kStages * kStageBytes + 16 * kStages;

template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
chain_hop_kernel(const uint8_t* __restrict__ src,
                 const uint8_t* __restrict__ wb, uint8_t* __restrict__ dst,
                 int M, int K, int row_major) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int kES = kInt8 ? 1 : 2;          // bytes per value
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t bars = smem_addr(smem + kStages * kStageBytes);
  const uint32_t full = bars, empty = bars + 8 * kStages;

  const int n_tile = blockIdx.x, m_tile = blockIdx.y;
  const int nkb = K * kES / 128;              // K blocks of a row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);   // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- the producer: one lane keeps the ring of (a, w) K blocks full
    if (lane == 0) {
      const uint8_t* a_run = src + (size_t)m_tile * nkb * kABytes;
      const uint8_t* w_run = wb + (size_t)n_tile * nkb * kBBytes;
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % kStages;
        mbar_wait(empty + 8 * s, ((kb / kStages) & 1) ^ 1);
        const uint32_t stage = smem_addr(smem + s * kStageBytes);
        mbar_arrive_expect_tx(full + 8 * s, kStageBytes);
        bulk_copy(stage, a_run + (size_t)kb * kABytes, kABytes, full + 8 * s);
        bulk_copy(stage + kABytes, w_run + (size_t)kb * kBBytes, kBBytes,
                  full + 8 * s);
      }
    }
    return;
  }

  // ---- the consumers: warpgroup g owns rows 128 g .. 128 g + 127 ----
  const int g = warp / 4;
  Acc acc[2][kBN / 2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[m][i] = 0;

  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb % kStages;
    mbar_wait(full + 8 * s, (kb / kStages) & 1);
    const uint32_t a0 = smem_addr(smem + s * kStageBytes) + g * 128 * 16;
    const uint32_t b0 = smem_addr(smem + s * kStageBytes + kABytes);
#pragma unroll
    for (int m = 0; m < 2; ++m) fence_sums(acc[m]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSlices / 2; ++ks) {
      const uint64_t db = operand_desc(b0 + 2 * ks * kBN * 16, kBN * 16, 128);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint64_t da = operand_desc(
            a0 + (2 * ks * kBM + m * 64) * 16, kBM * 16, 128);
        if constexpr (kInt8) Wgmma<kBN>::s8(acc[m], da, db);
        else Wgmma<kBN>::bf16(acc[m], da, db);
      }
    }
    wgmma_commit();
    if (kb > 0) {
      // the products of the K block before are done: hand its stage back
      wgmma_wait<1>();
      if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * ((kb - 1) % kStages));
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < 2; ++m) fence_sums(acc[m]);

  // ---- epilogue: requantise into a [slice][row][16 B] tile over the ring
  // (every copy has landed and every product is done once both warpgroups
  // pass the barrier), then 16-byte stores
  consumer_barrier<kConsumers>();
  constexpr int kOutSlices = kBN * kES / 16;  // 16 (bf16) or 8 (int8)
  const int lr = g * 128 + (warp % 4) * 16 + lane / 4;
  const int lc = (lane % 4) * 2;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = lr + m * 64 + h * 8, col = 8 * j + lc;
        const Acc y0 = acc[m][4 * j + 2 * h], y1 = acc[m][4 * j + 2 * h + 1];
        const int byte = col * kES;
        uint8_t* p = smem + (byte / 16) * kBM * 16 + row * 16 + byte % 16;
        if constexpr (kInt8) {
          const int q0 = max(-127, min(127, (int)y0 >> 10));
          const int q1 = max(-127, min(127, (int)y1 >> 10));
          *reinterpret_cast<uint16_t*>(p) =
              (uint16_t)((uint8_t)q0 | ((uint16_t)(uint8_t)q1 << 8));
        } else {
          *reinterpret_cast<__nv_bfloat162*>(p) =
              __floats2bfloat162_rn((float)y0 * 0.03125f,
                                    (float)y1 * 0.03125f);
        }
      }
  consumer_barrier<kConsumers>();
  const int tid = threadIdx.x;
  if (!row_major) {
    // the next hop's operand: this tile is kOutSlices contiguous runs of
    // 256 rows, at K block n_tile * kES of row tile m_tile
    uint4* out = reinterpret_cast<uint4*>(
        dst + ((size_t)m_tile * nkb + (size_t)n_tile * kES) * kABytes);
    const uint4* tile = reinterpret_cast<const uint4*>(smem);
    for (int i = tid; i < kOutSlices * kBM; i += kConsumers) out[i] = tile[i];
  } else {
    const size_t row_bytes = (size_t)K * kES;
    for (int i = tid; i < kOutSlices * kBM; i += kConsumers) {
      const int row = i / kOutSlices, sl = i % kOutSlices;
      const int r = m_tile * kBM + row;
      if (r < M)
        *reinterpret_cast<uint4*>(dst + r * row_bytes + n_tile * kBN * kES
                                  + sl * 16) =
            *reinterpret_cast<const uint4*>(smem + sl * kBM * 16 + row * 16);
    }
  }
}

template <bool kInt8>
int chain(const void* a, const void* w, void* buf, void* out, int M, int K,
          int hops, void* stream) {
  if (M < 1 || K < kBN || K % kBN != 0 || hops < 1)
    return (int)cudaErrorInvalidValue;
  static std::atomic<bool> prepared[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  e = allow_shared_memory(chain_hop_kernel<kInt8>, dev, prepared);
  if (e != cudaSuccess) return (int)e;
  const int m_tiles = (M + kBM - 1) / kBM;
  const dim3 grid(K / kBN, m_tiles);
  // hop h reads ping[h % 2] and writes ping[(h + 1) % 2], the last the
  // row-major result
  uint8_t* ping[2] = {const_cast<uint8_t*>(static_cast<const uint8_t*>(a)),
                      static_cast<uint8_t*>(buf)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int h = 0; h < hops; ++h) {
    const bool last = h == hops - 1;
    chain_hop_kernel<kInt8><<<grid, kThreads, kSmem, s>>>(
        ping[h % 2], static_cast<const uint8_t*>(w),
        last ? static_cast<uint8_t*>(out) : ping[(h + 1) % 2], M, K, last);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// a, buf: [M padded to 256, K] in the blocked layout above (a is written
// too: it is the wrapper's own packed copy); w: w^T ([K, K], wt[n, k] =
// w[k, n]) blocked by 128-row tiles the same way; out: [M, K] row-major.
// `hops` >= 1 launches on `stream`; returns the first failing launch's
// cudaError_t, or 0.
extern "C" int chain_int8(const void* a, const void* w, void* buf, void* out,
                          int M, int K, int hops, void* stream) {
  return chain<true>(a, w, buf, out, M, K, hops, stream);
}

// The same with bf16 operands, f32 sums and the factor 1 / 32.
extern "C" int chain_bf16(const void* a, const void* w, void* buf, void* out,
                          int M, int K, int hops, void* stream) {
  return chain<false>(a, w, buf, out, M, K, hops, stream);
}
