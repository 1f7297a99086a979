// K1: one convolution of a HiFi-GAN multi-receptive-field (MRF) stage, with
// the stage's elementwise work fused into its load and its epilogue.
//
// Replaces wetts_tpu/models/mrf_pallas.py:mrf_stage_pallas, the Pallas TPU
// kernel that runs a whole MRF stage in the TPU's space-to-depth layout. Here
// the wrapper (wetts_tpu_torch/models/mrf.py:mrf_stage) launches this kernel
// once per conv of the stage, 18 times for a VITS-base stage, in the port's
// own [B, T, C] layout with the weights in torch layout [C_out, C_in, K]:
//
//   out[b, t, o] (op)= scale * (bias[o] + res[b, t, o]
//                      + sum_{k, i} w[o, i, k] * lrelu(x[b, t + k*dil - pad, i]))
//
// with x read as zero outside [0, T) (each conv zero-pads its own input) and
// `op` one of store / store-scaled / accumulate-scaled, so the residual add
// and the mean over the stage's branches cost no separate pass.
//
// What bounds it: arithmetic. A v1 stage does 126 C x C taps per output
// sample (2*C*C*126 flops) against 2*C*4 bytes of activation traffic, so in
// f32 it is bound by the CUDA cores' 67 TFLOP/s, far above the memory
// bound. The design is a direct convolution on CUDA cores that keeps each
// block busy on arithmetic:
// - a block owns a 128-sample x 64-channel output tile (256 x 32 when
//   C <= 32); each thread accumulates 8 x 4 outputs in f32 registers with
//   16-byte shared loads (three loads per 32 fused multiply-adds);
// - input channels are consumed 8 at a time: the input tile with its
//   (K-1)*dil halo and the weight chunk are staged in shared memory by
//   cp.async, double-buffered so the next chunk's copies fly while this one
//   is computed; the leaky relu is applied in shared memory once per tile;
// - the tap count K is a template argument (3, 5, 7, 9 or 11), so the tap
//   loop unrolls and the staging index arithmetic divides by constants.
// Measured on an H100 (PERF.md) this is about 2.5x above the f32 bound.
// Tensor cores (TF32/bf16 wgmma), TMA and fusing the whole stage into one
// launch are later work.
//
// The kernel has two instances, as the TPU kernel has: f32 in and out, and
// bf16 in and out (activations, residual, weights and bias in bf16). Both
// accumulate in f32 and keep the shared tiles in f32. The bf16 instance
// converts while it stages (plain loads instead of cp.async, the leaky relu
// rounded to bf16 as PyTorch rounds it, then widened), does the epilogue in
// f32 and rounds once at the store.
//
// C must be a multiple of 4 (16-byte vectors along channels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kThreads = 256;
constexpr int kCi = 8;  // input channels staged per step

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// asynchronous global -> shared copies; `valid` false zero-fills the bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 4 neighbouring values of the activation type, widened to f32, and back
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// leaky relu of a bf16 value, rounded to bf16 and widened again
__device__ __forceinline__ float lrelu_bf16(float v, float slope) {
  return v > 0.f ? v : __bfloat162float(__float2bfloat16_rn(v * slope));
}

template <typename XT, int TCO, int TT, int K>
__global__ void __launch_bounds__(kThreads)
mrf_conv_kernel(const XT* __restrict__ x, const XT* __restrict__ w,
                const XT* __restrict__ bias, const XT* res, XT* out,
                int T, int C, int dil, float slope, float scale, int mode) {
  constexpr bool kF32 = std::is_same<XT, float>::value;
  constexpr int TX = TCO / 4;          // threads along output channels
  constexpr int TY = kThreads / TX;    // threads along time
  constexpr int TPT = TT / TY;         // time rows per thread
  constexpr int WS = TCO + 4;          // weight row stride (16-byte aligned)
  constexpr int KS = kCi * WS + 4;     // weight tap stride, off the banks
  extern __shared__ float4 smem4[];

  const int halo = (K - 1) * dil;
  const int pad = halo / 2;
  const int rows = TT + halo;
  // two buffers, each [rows][kCi] inputs then [K][kCi][WS] weights: the
  // copies of chunk c + 1 are in flight while chunk c is computed
  float* bufs[2];
  bufs[0] = reinterpret_cast<float*>(smem4);
  bufs[1] = bufs[0] + rows * kCi + K * KS;

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * TT;
  const int co0 = blockIdx.y * TCO;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const XT* xb = x + (size_t)b * T * C;
  const int n_chunks = (C + kCi - 1) / kCi;

  // input tile rows t0 - pad .. t0 + TT + halo - pad (zero outside [0, T)
  // and past C), and the weight chunk: for one output channel, (input
  // channel, tap) runs are contiguous in [C_out][C_in][K]
  auto issue = [&](int chunk, float* buf) {
    const int ci0 = chunk * kCi;
    for (int i = threadIdx.x; i < rows * (kCi / 4); i += kThreads) {
      const int t = t0 - pad + i / (kCi / 4);
      const int ci = ci0 + (i % (kCi / 4)) * 4;
      const bool ok = t >= 0 && t < T && ci < C;
      if constexpr (kF32) {
        cp_async16(buf + 4 * i, ok ? xb + (size_t)t * C + ci : xb, ok);
      } else {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok) {
          v = load4(xb + (size_t)t * C + ci);
          v.x = lrelu_bf16(v.x, slope); v.y = lrelu_bf16(v.y, slope);
          v.z = lrelu_bf16(v.z, slope); v.w = lrelu_bf16(v.w, slope);
        }
        store4(buf + 4 * i, v);
      }
    }
    float* ws = buf + rows * kCi;
    for (int i = threadIdx.x; i < TCO * kCi * K; i += kThreads) {
      const int k = i % K;
      const int c = (i / K) % kCi;
      const int o = i / (K * kCi);
      const int co = co0 + o;
      const int ci = ci0 + c;
      const bool ok = co < C && ci < C;
      if constexpr (kF32) {
        cp_async4(ws + k * KS + c * WS + o,
                  ok ? w + ((size_t)co * C + ci) * K + k : w, ok);
      } else {
        ws[k * KS + c * WS + o] =
            ok ? __bfloat162float(w[((size_t)co * C + ci) * K + k]) : 0.f;
      }
    }
    cp_async_commit();
  };

  float acc[TPT][4];
#pragma unroll
  for (int i = 0; i < TPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  issue(0, bufs[0]);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    float* xs = bufs[chunk & 1];
    if (chunk + 1 < n_chunks) {
      issue(chunk + 1, bufs[(chunk + 1) & 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // leaky relu on the inputs this thread copied (its copies are done);
    // the bf16 instance applied it while staging
    if constexpr (kF32) {
      for (int i = threadIdx.x; i < rows * (kCi / 4); i += kThreads) {
        float4 v = reinterpret_cast<float4*>(xs)[i];
        v.x = v.x >= 0.f ? v.x : v.x * slope;
        v.y = v.y >= 0.f ? v.y : v.y * slope;
        v.z = v.z >= 0.f ? v.z : v.z * slope;
        v.w = v.w >= 0.f ? v.w : v.w * slope;
        reinterpret_cast<float4*>(xs)[i] = v;
      }
    }
    __syncthreads();

    const float* ws = xs + rows * kCi;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float* xk = xs + (ty + k * dil) * kCi;
      const float* wk = ws + k * KS + tx * 4;
#pragma unroll
      for (int cg = 0; cg < kCi; cg += 4) {
        float4 a[TPT];
#pragma unroll
        for (int i = 0; i < TPT; ++i)
          a[i] = *reinterpret_cast<const float4*>(xk + i * TY * kCi + cg);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 wv =
              *reinterpret_cast<const float4*>(wk + (cg + cc) * WS);
#pragma unroll
          for (int i = 0; i < TPT; ++i) {
            const float av = cc == 0 ? a[i].x
                           : cc == 1 ? a[i].y
                           : cc == 2 ? a[i].z : a[i].w;
            acc[i][0] = fmaf(av, wv.x, acc[i][0]);
            acc[i][1] = fmaf(av, wv.y, acc[i][1]);
            acc[i][2] = fmaf(av, wv.z, acc[i][2]);
            acc[i][3] = fmaf(av, wv.w, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();  // the next issue overwrites this buffer
  }

  // epilogue: bias, residual, then store / store-scaled / accumulate-scaled
  const int co = co0 + tx * 4;
  if (co >= C) return;
  const float4 bv = load4(bias + co);
#pragma unroll
  for (int i = 0; i < TPT; ++i) {
    const int t = t0 + ty + i * TY;
    if (t >= T) continue;
    const size_t idx = ((size_t)b * T + t) * C + co;
    float4 v = make_float4(acc[i][0] + bv.x, acc[i][1] + bv.y,
                           acc[i][2] + bv.z, acc[i][3] + bv.w);
    if (res != nullptr) {
      const float4 r = load4(res + idx);
      v.x += r.x; v.y += r.y; v.z += r.z; v.w += r.w;
    }
    if (mode == 1) {
      v.x *= scale; v.y *= scale; v.z *= scale; v.w *= scale;
    } else if (mode == 2) {
      const float4 p = load4(out + idx);
      v.x = p.x + v.x * scale; v.y = p.y + v.y * scale;
      v.z = p.z + v.z * scale; v.w = p.w + v.w * scale;
    }
    store4(out + idx, v);
  }
}

template <typename XT, int TCO, int TT, int K>
cudaError_t launch(const XT* x, const XT* w, const XT* bias,
                   const XT* res, XT* out, int B, int T, int C,
                   int dil, float slope, float scale, int mode,
                   cudaStream_t stream) {
  constexpr int KS = kCi * (TCO + 4) + 4;
  const size_t smem = 2 * ((size_t)(TT + (K - 1) * dil) * kCi
                            + (size_t)K * KS) * sizeof(float);
  // above 48 KB an instance must be allowed more dynamic shared memory; it
  // is allowed the device's whole opt-in size once per device (the
  // allowance is a ceiling: occupancy follows each launch's own size)
  static std::atomic<bool> allowed[kMaxDevices];
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!allowed[dev].load()) {
      int optin = 0;
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e != cudaSuccess) return e;
      e = cudaFuncSetAttribute(mrf_conv_kernel<XT, TCO, TT, K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
      if (e != cudaSuccess) return e;
      allowed[dev].store(true);
    }
  }
  const dim3 grid((T + TT - 1) / TT, (C + TCO - 1) / TCO, B);
  mrf_conv_kernel<XT, TCO, TT, K><<<grid, kThreads, smem, stream>>>(
      x, w, bias, res, out, T, C, dil, slope, scale, mode);
  return cudaGetLastError();
}

// the tap count is a template argument, so the tap loop unrolls and the
// weight-staging index arithmetic divides by constants
template <typename XT, int TCO, int TT>
cudaError_t launch_taps(const XT* x, const XT* w, const XT* bias,
                        const XT* res, XT* out, int B, int T, int C,
                        int K, int dil, float slope, float scale, int mode,
                        cudaStream_t stream) {
#define MRF_TAPS(k)                                                        \
  case k:                                                                  \
    return launch<XT, TCO, TT, k>(x, w, bias, res, out, B, T, C, dil,      \
                                  slope, scale, mode, stream);
  switch (K) {
    MRF_TAPS(3) MRF_TAPS(5) MRF_TAPS(7) MRF_TAPS(9) MRF_TAPS(11)
    default:
      return cudaErrorInvalidValue;
  }
#undef MRF_TAPS
}

template <typename XT>
int mrf_conv(const void* x, const void* w, const void* bias, const void* res,
             void* out, int B, int T, int C, int K, int dil, float slope,
             float scale, int mode, void* stream) {
  if (C % 4 != 0 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const XT* xp = static_cast<const XT*>(x);
  const XT* wp = static_cast<const XT*>(w);
  const XT* bp = static_cast<const XT*>(bias);
  const XT* rp = static_cast<const XT*>(res);
  XT* op = static_cast<XT*>(out);
  if (C > 32)
    return (int)launch_taps<XT, 64, 128>(xp, wp, bp, rp, op, B, T, C, K, dil,
                                         slope, scale, mode, s);
  return (int)launch_taps<XT, 32, 256>(xp, wp, bp, rp, op, B, T, C, K, dil,
                                       slope, scale, mode, s);
}

}  // namespace

// x, res, out: [B, T, C] contiguous (res may be null); w: [C, C, K] with K
// in {3, 5, 7, 9, 11}; bias: [C]; all f32 (mrf_conv_f32) or all bf16
// (mrf_conv_bf16). mode 0: out = v; 1: out = scale * v; 2: out += scale * v.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int mrf_conv_f32(const void* x, const void* w, const void* bias,
                            const void* res, void* out, int B, int T, int C,
                            int K, int dil, float slope, float scale, int mode,
                            void* stream) {
  return mrf_conv<float>(x, w, bias, res, out, B, T, C, K, dil, slope, scale,
                         mode, stream);
}

extern "C" int mrf_conv_bf16(const void* x, const void* w, const void* bias,
                             const void* res, void* out, int B, int T, int C,
                             int K, int dil, float slope, float scale,
                             int mode, void* stream) {
  return mrf_conv<__nv_bfloat16>(x, w, bias, res, out, B, T, C, K, dil, slope,
                                 scale, mode, stream);
}
