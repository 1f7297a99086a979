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
// a: [M, K], w: [K, K]; the rows of a are independent, so the chain of one
// row tile never leaves the block.
//
// What bounds it: operations (2 * M * K * K * hops against M * K + K * K
// bytes in and M * K out), on the tensor cores. The TPU's 512 x 1024 tile
// (512 KB in int8) does not fit Hopper's 227 KB of shared memory, so the
// design is the chain in ONE launch with a smaller row tile:
// - a block owns 64 rows (int8) or 32 rows (bf16) and keeps two copies of
//   its a tile in shared memory, the hop's input and its output, which swap
//   after each hop; a goes to device memory only after the last hop;
// - w (1 MB or 2 MB, read by every block on every hop) streams from L2 in
//   tiles of 128 output columns x 256 bytes of K, staged by cp.async and
//   double-buffered across the whole (hop, column, K) sequence; the wrapper
//   hands w over transposed, [N, K], so that both operands have K
//   contiguous, as mma's row.col form wants them;
// - 8 warps as 2 x 4 over the 64 (32) x 128 output chunk; the products are
//   mma.sync.m16n8k32 (s8 -> s32) and mma.sync.m16n8k16 (bf16 -> f32), whose
//   fragments have the same byte layout, so both chains share one loop;
// - the requantisation is the epilogue of the last K step and writes the
//   next hop's operand straight into shared memory.
// Rows are padded by 16 bytes, so the 32-bit fragment loads hit 32 banks.
// wgmma, TMA and ldmatrix are later work.
//
// K must be a multiple of 256 (int8) or 128 (bf16), and both a tiles must
// fit in shared memory (K <= 1024 in either type).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kThreads = 256;
constexpr int kTN = 128;    // output columns per staged w tile
constexpr int kKB = 256;    // bytes of K per staged w tile
constexpr int kPad = 16;    // bytes of padding per shared-memory row
constexpr int kSW = kKB + kPad;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the requantised pair (columns c, c + 1 of one row) into the next operand
__device__ __forceinline__ void requant_store(unsigned char* row, int col,
                                              int y0, int y1) {
  const int q0 = max(-127, min(127, y0 >> 10));
  const int q1 = max(-127, min(127, y1 >> 10));
  *reinterpret_cast<uint16_t*>(row + col) =
      (uint16_t)((uint8_t)(int8_t)q0 | ((uint16_t)(uint8_t)(int8_t)q1 << 8));
}

__device__ __forceinline__ void requant_store(unsigned char* row, int col,
                                              float y0, float y1) {
  *reinterpret_cast<__nv_bfloat162*>(row + 2 * col) =
      __floats2bfloat162_rn(y0 * 0.03125f, y1 * 0.03125f);
}

// ACC: int (int8 operands, ES = 1 byte) or float (bf16 operands, ES = 2);
// MT: 16-row tiles per warp, so a block owns TM = 32 * MT rows
template <typename ACC, int ES, int MT>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const unsigned char* __restrict__ a,
             const unsigned char* __restrict__ wt, unsigned char* out, int M,
             int K, int hops) {
  constexpr int TM = 32 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_bytes = K * ES;
  const int SA = row_bytes + kPad;
  unsigned char* acur = smem;
  unsigned char* anext = smem + (size_t)TM * SA;
  unsigned char* wbuf0 = anext + (size_t)TM * SA;
  unsigned char* wbuf1 = wbuf0 + (size_t)kTN * kSW;

  const int m0 = blockIdx.x * TM;
  const int n_nc = K / kTN;           // w is square: N = K
  const int n_kc = row_bytes / kKB;
  const int per_hop = n_nc * n_kc;
  const int total = hops * per_hop;

  // the block's rows of a (zero past M)
  {
    const int per_row = row_bytes / 16;
    for (int i = threadIdx.x; i < TM * per_row; i += kThreads) {
      const int r = i / per_row;
      const int q = i - r * per_row;
      const bool ok = m0 + r < M;
      cp_async16(acur + (size_t)r * SA + q * 16,
                 ok ? a + (size_t)(m0 + r) * row_bytes + q * 16 : a, ok);
    }
    cp_async_commit();
  }
  // tile (nc, kc) of w^T: rows nc * 128 .., bytes kc * 256 ..
  auto prefetch = [&](int step, unsigned char* buf) {
    const int s = step % per_hop;
    const int nc = s / n_kc;
    const int kc = s - nc * n_kc;
    const unsigned char* src =
        wt + (size_t)nc * kTN * row_bytes + (size_t)kc * kKB;
    for (int i = threadIdx.x; i < kTN * (kKB / 16); i += kThreads) {
      const int n = i / (kKB / 16);
      const int q = i - n * (kKB / 16);
      cp_async16(buf + n * kSW + q * 16,
                 src + (size_t)n * row_bytes + q * 16, true);
    }
    cp_async_commit();
  };
  if (total > 0) prefetch(0, wbuf0);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp & 1;    // 2 warps along the rows
  const int wn = warp >> 1;   // 4 warps along the 128 columns, 32 each

  ACC acc[MT][4][4];
  for (int step = 0; step < total; ++step) {
    unsigned char* buf = (step & 1) ? wbuf1 : wbuf0;
    if (step + 1 < total) {
      prefetch(step + 1, (step & 1) ? wbuf0 : wbuf1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this step's w tile; at step 0 the a tile as well

    const int s = step % per_hop;
    const int nc = s / n_kc;
    const int kc = s - nc * n_kc;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;
    }
    const unsigned char* arow =
        acur + (size_t)(wm * 16 * MT + g) * SA + (size_t)kc * kKB + 4 * tig;
    const unsigned char* brow = buf + (size_t)(wn * 32 + g) * kSW + 4 * tig;
#pragma unroll 2
    for (int ks = 0; ks < kKB; ks += 32) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const unsigned char* base = arow + (size_t)mt * 16 * SA + ks;
        af[mt][0] = ld32(base);
        af[mt][1] = ld32(base + 8 * SA);
        af[mt][2] = ld32(base + 16);
        af[mt][3] = ld32(base + 8 * SA + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const unsigned char* base = brow + nt * 8 * kSW + ks;
        const uint32_t bf[2] = {ld32(base), ld32(base + 16)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma(acc[mt][nt], af[mt], bf);
      }
    }
    if (kc == n_kc - 1) {
      // requantise this 128-column chunk into the next hop's operand
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = nc * kTN + wn * 32 + nt * 8 + 2 * tig;
          unsigned char* r0 = anext + (size_t)(wm * 16 * MT + mt * 16 + g) * SA;
          requant_store(r0, col, acc[mt][nt][0], acc[mt][nt][1]);
          requant_store(r0 + 8 * SA, col, acc[mt][nt][2], acc[mt][nt][3]);
        }
    }
    __syncthreads();  // buf is free for the prefetch after next; at a hop's
                      // end, anext is complete
    if (s == per_hop - 1) {
      unsigned char* t = acur;
      acur = anext;
      anext = t;
    }
  }

  // the block's rows after the last hop (with no hop, the copied a tile)
  cp_async_wait<0>();
  __syncthreads();
  const int per_row = row_bytes / 16;
  for (int i = threadIdx.x; i < TM * per_row; i += kThreads) {
    const int r = i / per_row;
    const int q = i - r * per_row;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * row_bytes + q * 16) =
          *reinterpret_cast<const uint4*>(acur + (size_t)r * SA + q * 16);
  }
}

template <typename ACC, int ES, int MT>
cudaError_t launch(const void* a, const void* wt, void* out, int M, int K,
                   int hops, cudaStream_t stream) {
  constexpr int TM = 32 * MT;
  if (M < 1 || K < 1 || hops < 0 || (K * ES) % kKB != 0 || K % kTN != 0)
    return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)TM * (K * ES + kPad) + 2 * (size_t)kTN * kSW;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  static std::atomic<int> optin[kMaxDevices];
  if (optin[dev].load() == 0) {
    int bytes = 0;
    e = cudaDeviceGetAttribute(&bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(chain_kernel<ACC, ES, MT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    optin[dev].store(bytes);
  }
  if (smem > (size_t)optin[dev].load()) return cudaErrorInvalidValue;
  chain_kernel<ACC, ES, MT><<<(M + TM - 1) / TM, kThreads, smem, stream>>>(
      static_cast<const unsigned char*>(a),
      static_cast<const unsigned char*>(wt),
      static_cast<unsigned char*>(out), M, K, hops);
  return cudaGetLastError();
}

}  // namespace

// a, out: [M, K] int8 (out may not alias a); wt: [K, K] int8, w transposed
// (wt[n, k] = w[k, n]). Returns the launch's cudaError_t.
extern "C" int chain_int8(const void* a, const void* wt, void* out, int M,
                          int K, int hops, void* stream) {
  return (int)launch<int, 1, 2>(a, wt, out, M, K, hops,
                                static_cast<cudaStream_t>(stream));
}

// The same with bf16 operands, f32 sums and the factor 1 / 32.
extern "C" int chain_bf16(const void* a, const void* wt, void* out, int M,
                          int K, int hops, void* stream) {
  return (int)launch<float, 2, 1>(a, wt, out, M, K, hops,
                                  static_cast<cudaStream_t>(stream));
}
