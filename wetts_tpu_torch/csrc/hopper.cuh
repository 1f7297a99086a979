// Building blocks shared by the port's Hopper kernels (sm_90a): mbarriers,
// bulk and 16-byte asynchronous copies, and warpgroup matrix products
// (wgmma) on operands in shared memory in the no-swizzle K-major layout.
//
// The layout: an operand tile is stored [16-byte K slice][row][16 bytes],
// so that an 8-row core matrix is 128 contiguous bytes, 8-row groups are
// 128 bytes apart and K slices `rows * 16` bytes apart. One wgmma step reads
// two K slices (16 bf16, 8 tf32 or 32 int8 values of each row), and
// shifting the operand by whole rows is a change of its descriptor's start
// address. Included by mrf_stage.cu (K1), vocos_backbone.cu (VB, which
// reads its operands under the 128-byte swizzle instead), int8_mrf_conv.cu
// (Q1), int8_chain.cu (K3) and mas.cu (K2: mbarriers, the timed spin and
// bulk copies only); each
// builds into its own library, so everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// makes the barriers' initialisation visible to the asynchronous proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// a spin of more than two seconds is a broken hand-over: trap rather than
// hang the card. Called now and then from a spin loop, with `since` 0 at
// the loop's start
__device__ __forceinline__ void trap_if_stuck(unsigned long long* since) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
  if (*since == 0) *since = now;
  else if (now - *since > 2000000000ull) __trap();
}

// wait until the barrier's phase differs from `parity`, trapping after two
// seconds. A thread that expects to wait long passes `sleep_ns`: it sleeps
// between tries, so that its spinning takes no issue slots from the warps
// that share its scheduler
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity,
                                          unsigned sleep_ns = 0) {
  unsigned long long since = 0;
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (sleep_ns) __nanosleep(sleep_ns);
    if ((spins & 63) == 63) trap_if_stuck(&since);
  }
}

// ---- copies ---------------------------------------------------------------

// `bytes` (a multiple of 16) contiguous bytes global -> shared, completing
// on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// 8 or 16 bytes global -> shared, asynchronously; `valid` false fills the
// destination with zeros instead
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(dst), "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// stores of the generic proxy to shared memory, before the tensor cores
// (the asynchronous proxy) read them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of the first THREADS threads (the consumer warpgroups) alone
template <int THREADS>
__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(THREADS) : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// v = hi + lo with both parts TF32 values (round to nearest, ties away):
// three TF32 products hi*lo + lo*hi + hi*hi keep an f32 product's accuracy
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

// descriptor of a K-major operand without swizzle: 8 rows x 16 bytes core
// matrices, `lbo` bytes between the two K slices of one instruction, `sbo`
// bytes between 8-row groups
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr, uint32_t lbo,
                                                 uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

#define HOPPER_REGS_8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define HOPPER_REGS_16 HOPPER_REGS_8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_REGS_32 HOPPER_REGS_16                                       \
  ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define HOPPER_REGS_64 HOPPER_REGS_32                                       \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "   \
  "%60, %61, %62, %63"
// the sums as read-write operands; C is the constraint, "+f" or "+r"
#define HOPPER_ACC_8(C, d, o)                                               \
  C(d[o]), C(d[o + 1]), C(d[o + 2]), C(d[o + 3]), C(d[o + 4]), C(d[o + 5]), \
      C(d[o + 6]), C(d[o + 7])
#define HOPPER_ACC_16(C, d, o) HOPPER_ACC_8(C, d, o), HOPPER_ACC_8(C, d, o + 8)
#define HOPPER_ACC_32(C, d, o) \
  HOPPER_ACC_16(C, d, o), HOPPER_ACC_16(C, d, o + 16)
#define HOPPER_ACC_64(C, d, o) \
  HOPPER_ACC_32(C, d, o), HOPPER_ACC_32(C, d, o + 32)

// d[64 x N] += a[64 x K] * b[N x K]^T, both operands from shared memory; a
// thread of the warpgroup holds N / 2 of the sums: for each 8 columns j,
// rows lane / 4 and lane / 4 + 8 of its warp's 16, columns 8 j + 2 (lane %
// 4) and + 1, as d[4 j .. 4 j + 3]
template <int N> struct Wgmma;

#define HOPPER_WGMMA(N, REGS, ACC, A, B, P)                                  \
  template <> struct Wgmma<N> {                                              \
    static __device__ __forceinline__ void bf16(float (&d)[N / 2],           \
                                                uint64_t a, uint64_t b) {    \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                     \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "        \
          "{" REGS "}, " A ", " B ", p, 1, 1, 0, 0;\n}\n"                    \
          : ACC("+f", d, 0) : "l"(a), "l"(b), "r"(1));                       \
    }                                                                        \
    static __device__ __forceinline__ void tf32(float (&d)[N / 2],           \
                                                uint64_t a, uint64_t b) {    \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                     \
          "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 "         \
          "{" REGS "}, " A ", " B ", p, 1, 1;\n}\n"                          \
          : ACC("+f", d, 0) : "l"(a), "l"(b), "r"(1));                       \
    }                                                                        \
    static __device__ __forceinline__ void s8(int (&d)[N / 2], uint64_t a,   \
                                              uint64_t b) {                  \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                     \
          "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 "            \
          "{" REGS "}, " A ", " B ", p;\n}\n"                                \
          : ACC("+r", d, 0) : "l"(a), "l"(b), "r"(1));                       \
    }                                                                        \
  };

HOPPER_WGMMA(16, HOPPER_REGS_8, HOPPER_ACC_8, "%8", "%9", "%10")
HOPPER_WGMMA(32, HOPPER_REGS_16, HOPPER_ACC_16, "%16", "%17", "%18")
HOPPER_WGMMA(64, HOPPER_REGS_32, HOPPER_ACC_32, "%32", "%33", "%34")
HOPPER_WGMMA(128, HOPPER_REGS_64, HOPPER_ACC_64, "%64", "%65", "%66")

// keeps the compiler from moving reads or writes of the sums across the
// asynchronous products
template <typename T, int N>
__device__ __forceinline__ void fence_sums(T (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<T, float>::value)
      asm volatile("" : "+f"(d[i]) :: "memory");
    else
      asm volatile("" : "+r"(d[i]) :: "memory");
  }
}

// sets a kernel's dynamic shared-memory ceiling to the device's whole
// opt-in size and asks for the largest carve-out, once per device and
// kernel (`done` is the caller's per-kernel flag array)
template <typename Kernel>
cudaError_t allow_shared_memory(Kernel kernel, int dev,
                                std::atomic<bool>* done) {
  if (done[dev].load()) return cudaSuccess;
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  done[dev].store(true);
  return cudaSuccess;
}

}  // namespace
