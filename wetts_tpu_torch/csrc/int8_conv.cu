// int8 convolutions of the quantised HiFi-GAN decoder: the activation row
// scale (Q0) and the transposed conv of an upsample (Q2). The dilated
// stride-1 conv of an MRF stage (Q1) is csrc/int8_mrf_conv.cu.
//
// Replaces lax.conv_general_dilated on int8 operands in
// wetts_tpu/models/hifigan_fast.py:_conv (q8=True), which the TPU ran on its
// matrix unit through XLA, and the reduction that gives its activation
// scale. The wrappers are in wetts_tpu_torch/models/quant.py; activations
// are [B, T, C] (channels last), f32 or bf16.
//
//   sx[b]  = max(max_{t,c} |lrelu(x[b, t, c])|, 1e-12) / 127
//   xq     = clip(rint(lrelu(x) / sx[b]), -127, 127)             (int8)
//   acc    = sum_{tap, ci} wq[co, ci, tap] * xq[b, row(t, tap), ci]  (int32)
//   v      = rnd(f32(acc) * (sx[b] * sw[co]));  v = rnd(v + bias[co]);
//   out    = v
//
// with rnd the rounding to the activation type and x read as zero outside
// [0, T). The integer sums are exact, so the result differs from the plain
// PyTorch version only where the two round f32 to the output type; every
// float step is a single IEEE operation (no contraction).
//
// What bounds the transposed conv: arithmetic (2 * C_in * C_out * k / u
// operations per output sample against 2 * (C_in + C_out * u) bytes). The
// design is an implicit GEMM with mma.sync.m16n8k32 (s8 x s8 -> s32): for
// the taps j = p (mod u) that reach one output phase it is a stride-1 conv
// with ceil(k / u) taps over the input positions, whose outputs are written
// u apart; gridDim.y also runs over the u phases, and the weight scale is
// per (phase, channel).
// - M is time (128 positions per block), N the output channels (128, 64 or
//   32 per block), K the input channels of one tap; the taps are an outer
//   loop over shifted rows of one shared input tile;
// - the block reads its input tile with the taps' halo once, applies the
//   leaky relu and the quantisation on load and keeps it in shared memory
//   as int8, all input channels wide;
// - the weights of one (tap, 256-channel chunk) are staged by cp.async,
//   double-buffered, from a [phase, tap, C_out, C_in] layout packed once on
//   the host side; rows are padded by 16 bytes so fragment loads hit 32
//   banks;
// - each warp owns 32 positions x (8 * NT) channels, its int32 sums in
//   registers; fragments are plain 32-bit shared loads.
// Q1's wgmma design (int8_mrf_conv.cu) is the model for this one's next
// redesign.
//
// C_in must be a multiple of 32 and C_out of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kTT = 128;      // positions per block (4 warps of 32 along M)
constexpr int kChunk = 256;   // input channels of one staged weight tile
constexpr int kPad = 16;      // bytes of padding per shared-memory row

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

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the activation type: loads of 4 neighbours, and its rounding
template <typename XT> struct Io;

template <> struct Io<float> {
  static __device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ void load2(const float* p, float (&v)[2]) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
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
  static __device__ __forceinline__ void load2(const T* p, float (&v)[2]) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x; v[1] = f.y;
  }
  static __device__ __forceinline__ void store2(T* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// lrelu in the activation type (its product rounded as PyTorch rounds it)
template <typename XT>
__device__ __forceinline__ float lrelu(float v, float slope) {
  return v > 0.f ? v : Io<XT>::rnd(__fmul_rn(v, slope));
}

// ---------------------------------------------------------------- row scale

template <typename XT>
__global__ void __launch_bounds__(256)
row_amax_kernel(const XT* __restrict__ x, unsigned* amax_bits, long long n,
                float slope) {
  const XT* xb = x + (size_t)blockIdx.y * n;
  float m = 0.f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n / 4; i += (long long)gridDim.x * blockDim.x) {
    float v[4];
    Io<XT>::load4(xb + 4 * i, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) m = fmaxf(m, fabsf(lrelu<XT>(v[j], slope)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[8];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < 8; ++w) m = fmaxf(m, warp_max[w]);
    // non-negative floats order as their bit patterns
    atomicMax(amax_bits + blockIdx.y, __float_as_uint(m));
  }
}

__global__ void row_scale_finish_kernel(float* sx, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) sx[b] = __fdiv_rn(fmaxf(sx[b], 1e-12f), 127.f);
}

// --------------------------------------------------------------------- conv

struct ConvArgs {
  const void* x;       // [B, T_in, C_in]
  const float* sx;     // [B]
  const int8_t* wq;    // [phases, taps, C_out, C_in]
  const float* sw;     // [phases, C_out]
  const void* bias;    // [C_out] in the activation type, or null
  void* out;           // [B, T_out, C_out]
  int T_in, T_out, M;  // M: positions tiled over
  int C_in, C_out, n_co_tiles;
  int taps;            // taps per phase
  int row0;            // input row of tap 0 at position 0
  int step;            // input rows from one tap to the next
  int out_stride;      // output row of position m, phase p:
  int out_off;         //   m * out_stride + p + out_off
  float slope;
};

template <typename XT, int WARPS_N, int NT>
__global__ void __launch_bounds__(128 * WARPS_N)
int8_conv_kernel(const ConvArgs a) {
  constexpr int THREADS = 128 * WARPS_N;
  constexpr int TCO = WARPS_N * NT * 8;
  extern __shared__ __align__(16) int8_t smem[];

  const int p = blockIdx.y / a.n_co_tiles;
  const int co0 = (blockIdx.y - p * a.n_co_tiles) * TCO;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * kTT;
  const int rows = kTT + (a.taps - 1) * a.step;
  const int SA = a.C_in + kPad;
  const int CK = a.C_in < kChunk ? a.C_in : kChunk;
  const int SW = CK + kPad;
  const int n_chunks = (a.C_in + CK - 1) / CK;
  const int n_steps = a.taps * n_chunks;
  int8_t* xs = smem;
  int8_t* wbuf0 = smem + (size_t)rows * SA;
  int8_t* wbuf1 = wbuf0 + (size_t)TCO * SW;

  const int8_t* wq_p = a.wq + (size_t)p * a.taps * a.C_out * a.C_in;
  auto prefetch = [&](int s, int8_t* buf) {
    const int tap = s / n_chunks;
    const int k0 = (s - tap * n_chunks) * CK;
    const int ck = a.C_in - k0 < CK ? a.C_in - k0 : CK;
    const int per_row = ck / 16;
    const int8_t* src = wq_p + (size_t)tap * a.C_out * a.C_in + k0;
    for (int i = threadIdx.x; i < TCO * per_row; i += THREADS) {
      const int n = i / per_row;
      const int q = i - n * per_row;
      const bool ok = co0 + n < a.C_out;
      cp_async16(buf + n * SW + q * 16,
                 ok ? src + (size_t)(co0 + n) * a.C_in + q * 16 : a.wq, ok);
    }
    cp_async_commit();
  };
  prefetch(0, wbuf0);

  // the input tile, rows m0 + row0 .. + rows: leaky relu and quantisation
  // on load, zero outside [0, T_in)
  {
    const XT* xb = static_cast<const XT*>(a.x) + (size_t)b * a.T_in * a.C_in;
    const float sxb = a.sx[b];
    const int c4n = a.C_in / 4;
    for (int i = threadIdx.x; i < rows * c4n; i += THREADS) {
      const int r = i / c4n;
      const int c = (i - r * c4n) * 4;
      const int t = m0 + a.row0 + r;
      uint32_t packed = 0;
      if (t >= 0 && t < a.T_in) {
        float v[4];
        Io<XT>::load4(xb + (size_t)t * a.C_in + c, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int q = __float2int_rn(__fdiv_rn(lrelu<XT>(v[j], a.slope), sxb));
          q = max(-127, min(127, q));
          packed |= (uint32_t)(uint8_t)(int8_t)q << (8 * j);
        }
      }
      *reinterpret_cast<uint32_t*>(xs + (size_t)r * SA + c) = packed;
    }
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp & 3;
  const int wn = warp >> 2;

  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  for (int s = 0; s < n_steps; ++s) {
    int8_t* buf = (s & 1) ? wbuf1 : wbuf0;
    if (s + 1 < n_steps) {
      prefetch(s + 1, (s & 1) ? wbuf0 : wbuf1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this step's weights (and, at s = 0, the input tile)

    const int tap = s / n_chunks;
    const int k0 = (s - tap * n_chunks) * CK;
    const int ck = a.C_in - k0 < CK ? a.C_in - k0 : CK;
    const int8_t* arow =
        xs + (size_t)(wm * 32 + g + tap * a.step) * SA + k0 + 4 * tig;
    const int8_t* brow = buf + (size_t)(wn * NT * 8 + g) * SW + 4 * tig;
    for (int ks = 0; ks < ck; ks += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* base = arow + (size_t)mt * 16 * SA + ks;
        af[mt][0] = ld32(base);
        af[mt][1] = ld32(base + 8 * SA);
        af[mt][2] = ld32(base + 16);
        af[mt][3] = ld32(base + 8 * SA + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* base = brow + (size_t)nt * 8 * SW + ks;
        const uint32_t bf[2] = {ld32(base), ld32(base + 16)};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], af[mt], bf);
      }
    }
    __syncthreads();  // the next prefetch overwrites this buffer
  }

  // epilogue: dequantise, bias; a thread holds, per 16 x 8 tile, rows g
  // and g + 8 at channels 2 * tig, + 1
  const float sxb = a.sx[b];
  const XT* bias = static_cast<const XT*>(a.bias);
  XT* out = static_cast<XT*>(a.out);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int co = co0 + wn * NT * 8 + nt * 8 + 2 * tig;
    if (co >= a.C_out) continue;
    const float s0 = __fmul_rn(sxb, a.sw[(size_t)p * a.C_out + co]);
    const float s1 = __fmul_rn(sxb, a.sw[(size_t)p * a.C_out + co + 1]);
    float bv[2] = {0.f, 0.f};
    if (bias != nullptr) Io<XT>::load2(bias + co, bv);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mt * 16 + g + 8 * h;
        if (m >= a.M) continue;
        const int t = m * a.out_stride + p + a.out_off;
        if (t < 0 || t >= a.T_out) continue;
        const size_t idx = ((size_t)b * a.T_out + t) * a.C_out + co;
        float v0 = Io<XT>::rnd(
            __fmul_rn(__int2float_rn(acc[mt][nt][2 * h]), s0));
        float v1 = Io<XT>::rnd(
            __fmul_rn(__int2float_rn(acc[mt][nt][2 * h + 1]), s1));
        if (bias != nullptr) {
          v0 = Io<XT>::rnd(__fadd_rn(v0, bv[0]));
          v1 = Io<XT>::rnd(__fadd_rn(v1, bv[1]));
        }
        Io<XT>::store2(out + idx, v0, v1);
      }
    }
  }
}

template <typename XT, int WARPS_N, int NT>
cudaError_t launch(const ConvArgs& a, int B, int phases, cudaStream_t stream) {
  constexpr int TCO = WARPS_N * NT * 8;
  const int rows = kTT + (a.taps - 1) * a.step;
  const int CK = a.C_in < kChunk ? a.C_in : kChunk;
  const size_t smem = (size_t)rows * (a.C_in + kPad)
                      + 2 * (size_t)TCO * (CK + kPad);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  // above 48 KB an instance must be allowed more dynamic shared memory; it
  // is allowed the device's whole opt-in size once per device
  static std::atomic<int> optin[kMaxDevices];
  if (optin[dev].load() == 0) {
    int bytes = 0;
    e = cudaDeviceGetAttribute(&bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(int8_conv_kernel<XT, WARPS_N, NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    optin[dev].store(bytes);
  }
  if (smem > (size_t)optin[dev].load()) return cudaErrorInvalidValue;
  ConvArgs args = a;
  args.n_co_tiles = (a.C_out + TCO - 1) / TCO;
  const dim3 grid((a.M + kTT - 1) / kTT, args.n_co_tiles * phases, B);
  int8_conv_kernel<XT, WARPS_N, NT><<<grid, 128 * WARPS_N, smem, stream>>>(
      args);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_width(const ConvArgs& a, int B, int phases,
                         cudaStream_t stream) {
  if (a.C_out > 64) return launch<XT, 2, 8>(a, B, phases, stream);
  if (a.C_out > 32) return launch<XT, 1, 8>(a, B, phases, stream);
  return launch<XT, 1, 4>(a, B, phases, stream);
}

cudaError_t launch_type(const ConvArgs& a, int B, int phases, int is_bf16,
                        cudaStream_t stream) {
  if (a.C_in % 32 != 0 || a.C_out % 8 != 0 || a.taps < 1)
    return cudaErrorInvalidValue;
  if (is_bf16) return launch_width<__nv_bfloat16>(a, B, phases, stream);
  return launch_width<float>(a, B, phases, stream);
}

}  // namespace

// sx[b] = max(max |lrelu(x[b])|, 1e-12) / 127 over the n = T * C elements of
// row b (n % 4 == 0); x f32 or bf16. Three stream operations, no host sync.
extern "C" int int8_row_scale(const void* x, float* sx, int B, long long n,
                              float slope, int is_bf16, void* stream) {
  if (n % 4 != 0 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(sx, 0, sizeof(float) * B, s);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (n / 4 + 256 * 4 - 1) / (256 * 4);
  if (blocks > 128) blocks = 128;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, B);
  unsigned* bits = reinterpret_cast<unsigned*>(sx);
  if (is_bf16)
    row_amax_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), bits, n, slope);
  else
    row_amax_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), bits, n, slope);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  row_scale_finish_kernel<<<(B + 127) / 128, 128, 0, s>>>(sx, B);
  return (int)cudaGetLastError();
}

// Transposed conv of stride u and padding pd. wq: [u, taps, C_out, C_in],
// for phase p the taps j = p + u * (taps - 1 - i) in the order i; sw:
// [u, C_out] by the same p; out: [B, T_out, C_out]. Position m of phase p
// reads the input rows m - (taps - 1) .. m and writes row m * u + p - pd.
extern "C" int int8_conv_transpose1d(const void* x, const float* sx,
                                     const int8_t* wq, const float* sw,
                                     const void* bias, void* out, int B,
                                     int T_in, int T_out, int C_in, int C_out,
                                     int taps, int u, int pd, float slope,
                                     int is_bf16, void* stream) {
  if (u < 1 || T_out < 1) return (int)cudaErrorInvalidValue;
  ConvArgs a{};
  a.x = x; a.sx = sx; a.wq = wq; a.sw = sw; a.bias = bias;
  a.out = out;
  a.T_in = T_in; a.T_out = T_out; a.M = (T_out - 1 + pd) / u + 1;
  a.C_in = C_in; a.C_out = C_out;
  a.taps = taps; a.row0 = -(taps - 1); a.step = 1;
  a.out_stride = u; a.out_off = -pd;
  a.slope = slope;
  return (int)launch_type(a, B, u, is_bf16,
                          static_cast<cudaStream_t>(stream));
}
