// Q0: the activation row scale of the quantised HiFi-GAN decoder, where no
// epilogue gathered it (in the decoder only at conv_pre's output, the first
// upsample's input). Q1 and Q2 (csrc/int8_mrf_conv.cu) take the abs-max of
// what they store, which gives every other input's scale.
//
// Replaces the XLA reduction that gives an activation scale in
// wetts_tpu/models/hifigan_fast.py:_conv (q8=True). The wrapper is
// wetts_tpu_torch/models/quant.py:row_scale; activations are [B, T, C]
// (channels last), f32 or bf16:
//
//   sx[b] = max(max_{t,c} |lrelu(x[b, t, c])|, 1e-12) / 127   (true division)
//
// What bounds it: bytes (one read of x), 1-6 MB at v1's shapes, which is
// 0.3-2 us at 3.35 TB/s; so a launch costs more than the work. It is one
// launch: blocks of 256 threads take the max over their share of a row, each
// block writes its partial max, and the last block to finish (a ticket
// counter) takes the max of each row's partials, writes the finished scale
// and sets the counter back to zero for the next launch on the stream. No
// memset and no second kernel; the counter is the caller's, one per stream
// (quant.py), zeroed once when it is made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// the activation type: loads of 4 neighbours, and its rounding
template <typename XT> struct Io;

template <> struct Io<float> {
  static __device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
  static __device__ __forceinline__ float rnd(float v) { return v; }
};

template <> struct Io<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// lrelu in the activation type (its product rounded as PyTorch rounds it)
template <typename XT>
__device__ __forceinline__ float lrelu(float v, float slope) {
  return v > 0.f ? v : Io<XT>::rnd(__fmul_rn(v, slope));
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// grid (blocks per row, B); partial: [B][blocks per row]; ticket: one
// counter, zero at the start of the launch and again at its end
template <typename XT>
__global__ void __launch_bounds__(kThreads)
row_scale_kernel(const XT* __restrict__ x, float* __restrict__ sx,
                 float* partial, unsigned* ticket, long long n, float slope) {
  const XT* xb = x + (size_t)blockIdx.y * n;
  float m = 0.f;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n / 4; i += (long long)gridDim.x * kThreads) {
    float v[4];
    Io<XT>::load4(xb + 4 * i, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) m = fmaxf(m, fabsf(lrelu<XT>(v[j], slope)));
  }
  m = warp_max(m);
  __shared__ float warp_maxes[kThreads / 32];
  __shared__ bool last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_maxes[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) m = fmaxf(m, warp_maxes[w]);
    partial[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = m;
    // the partial is visible to the whole device before the ticket is
    // taken, so the block that takes the last ticket sees every partial
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int b = warp; b < (int)gridDim.y; b += kThreads / 32) {
    float r = 0.f;
    for (int i = lane; i < (int)gridDim.x; i += 32)
      r = fmaxf(r, __ldcg(partial + (size_t)b * gridDim.x + i));
    r = warp_max(r);
    if (lane == 0) sx[b] = __fdiv_rn(fmaxf(r, 1e-12f), 127.f);
  }
  // the next launch on this stream starts after this one ends
  if (threadIdx.x == 0) *ticket = 0u;
}

}  // namespace

// sx[b] = max(max |lrelu(x[b])|, 1e-12) / 127 over the n = T * C elements of
// row b (n % 4 == 0); x f32 or bf16. partial: B * max_blocks floats of
// scratch, which caps the blocks per row at max_blocks; ticket: a counter
// that is zero, and is zero again when the launch ends, used by one stream
// at a time. One launch, no host sync; returns its cudaError_t.
extern "C" int int8_row_scale(const void* x, float* sx, float* partial,
                              int max_blocks, unsigned* ticket, int B,
                              long long n, float slope, int is_bf16,
                              void* stream) {
  if (n % 4 != 0 || n < 0 || B < 1 || B > 65535 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = (n / 4 + kThreads * 4 - 1) / (kThreads * 4);
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, B);
  if (is_bf16)
    row_scale_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), sx, partial, ticket, n, slope);
  else
    row_scale_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), sx, partial, ticket, n, slope);
  return (int)cudaGetLastError();
}
