// K2: monotonic alignment search (MAS), forward dynamic programme and
// backtracking in one launch.
//
// Replaces wetts_tpu/ops/mas_pallas.py:maximum_path_pallas (body _mas_kernel),
// the Pallas TPU kernel that keeps the f32 DP table of 8 utterances in VMEM
// and replaces gathers by one-hot sums. Per utterance, with nc the masked
// score table [T_spec, T_text] (masked cells are -1e9) and lengths
// (t_spec, t_text):
//
//   v[y, x] = nc[y, x] + max(left, up)
//     left = v[y-1, x-1]   (x == 0: 0 at y == 0, else -1e9)
//     up   = v[y-1, x]     (x == y: -1e9)            v[-1, :] = -1e9
//
// then from (t_spec - 1, t_text - 1) upwards: row y takes column `index`,
// and index steps left when index > 0 and (index == y or
// v[y-1, index] < v[y-1, index-1]). The path is 1 at (y, index), 0 elsewhere,
// rows y >= t_spec all 0.
//
// Bit-exactness: one f32 add and one max per cell, in the order above, and
// the strict `<` on the same two table values the TPU kernel compares. There
// is no multiply, so nothing can contract into an fma; the add is written
// __fadd_rn all the same.
//
// What bounds it: latency, not bytes or operations. The bytes (the valid
// scores read once, the path written once) would take microseconds at the
// card's memory rate; the work is t_spec dependent steps, each a block-wide
// barrier. The design keeps each step short:
// - one block per utterance, threads across text positions (a strided loop
//   when T_text exceeds the block); only the valid t_spec x t_text corner is
//   walked, which is self-contained: a cell reads only cells above and to
//   its left;
// - the previous DP row lives in shared memory, double-buffered, with one
//   __syncthreads() per spec frame; v never goes to device memory;
// - scores are staged kRows frames at a time into shared memory, so a step
//   waits on shared memory and not on device memory;
// - backtracking needs one decision per cell, `x == y || v[y-1, x] <
//   v[y-1, x-1]`, which the forward pass has in hand: it is kept as one bit
//   per cell (a warp ballot per 32 columns), in shared memory where that
//   fits (1000 x 208 cells are 28 KB) and in a scratch buffer of the
//   wrapper's otherwise. One thread walks the bits back and records each
//   row's column; then the whole block writes the 0/1 rows, zeros included,
//   with neighbouring threads on neighbouring addresses, so no memset
//   precedes the launch.
// A later redesign has to move the per-row step time (ms / T_spec).

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kRows = 16;      // spec frames staged per chunk
constexpr int kThreads = 256;  // a multiple of 32 (one ballot word per warp)
constexpr int kMaxDevices = 64;

// Shared memory layout (floats / ints):
//   rows  [2][T_text]       the DP row, double-buffered
//   stage [kRows][T_text]   staged scores
//   then, unless `scratch` is given: bits [T_spec][W] and index [T_spec]
__global__ void __launch_bounds__(kThreads)
mas_kernel(const float* __restrict__ nc, const int* __restrict__ t_text_len,
           const int* __restrict__ t_spec_len, float* __restrict__ path,
           unsigned* __restrict__ scratch, int T_spec, int T_text) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int W = (T_text + 31) / 32;  // ballot words per row
  const int t_text = min(max(t_text_len[b], 1), T_text);
  const int t_spec = min(max(t_spec_len[b], 1), T_spec);
  const int t_text_pad = (t_text + 31) & ~31;  // whole warps take part

  float* rows = smem;
  float* stage = smem + 2 * T_text;
  unsigned* bits;
  int* index_of;
  if (scratch != nullptr) {
    bits = scratch + (size_t)b * T_spec * (W + 1);
    index_of = reinterpret_cast<int*>(bits + (size_t)T_spec * W);
  } else {
    bits = reinterpret_cast<unsigned*>(stage + kRows * T_text);
    index_of = reinterpret_cast<int*>(bits + (size_t)T_spec * W);
  }
  const float* nc_b = nc + (size_t)b * T_spec * T_text;

  for (int x = tid; x < t_text; x += kThreads) rows[x] = kNeg;

  // ---- forward DP ----
  for (int y0 = 0; y0 < t_spec; y0 += kRows) {
    const int n_rows = min(kRows, t_spec - y0);
    __syncthreads();  // the last chunk's reads of `stage` are done
    for (int i = tid; i < n_rows * t_text; i += kThreads) {
      const int r = i / t_text, x = i - r * t_text;
      stage[r * T_text + x] = nc_b[(size_t)(y0 + r) * T_text + x];
    }
    __syncthreads();
    for (int r = 0; r < n_rows; ++r) {
      const int y = y0 + r;
      const float* prev = rows + (y & 1) * T_text;
      float* cur = rows + ((y + 1) & 1) * T_text;
      for (int x = tid; x < t_text_pad; x += kThreads) {
        bool step_left = false;
        if (x < t_text) {
          const float up_raw = prev[x];
          const float left_raw = x > 0 ? prev[x - 1] : up_raw;
          const float left = x > 0 ? left_raw : (y == 0 ? 0.0f : kNeg);
          const float up = x == y ? kNeg : up_raw;
          cur[x] = __fadd_rn(stage[r * T_text + x], fmaxf(left, up));
          step_left = x == y || up_raw < left_raw;
        }
        const unsigned word = __ballot_sync(0xffffffffu, step_left);
        if (lane == 0) bits[(size_t)y * W + (x >> 5)] = word;
      }
      __syncthreads();  // `cur` is complete before it becomes `prev`
    }
  }

  // ---- backtracking: one thread walks the decision bits ----
  if (tid == 0) {
    int index = t_text - 1;
    for (int y = t_spec - 1; y >= 0; --y) {
      index_of[y] = index;
      if (y > 0 && index > 0 &&
          ((bits[(size_t)y * W + (index >> 5)] >> (index & 31)) & 1u))
        --index;
    }
  }
  __syncthreads();

  // ---- the 0/1 path, every cell of the padded table ----
  float* path_b = path + (size_t)b * T_spec * T_text;
  const int total = T_spec * T_text;
  for (int i = tid; i < total; i += kThreads) {
    const int y = i / T_text, x = i - y * T_text;
    path_b[i] = (y < t_spec && x == index_of[y]) ? 1.0f : 0.0f;
  }
}

}  // namespace

// Bytes of dynamic shared memory the kernel needs for [*, T_spec, T_text]
// when the decision bits live in shared memory (`with_bits`) or not.
extern "C" long long mas_shared_bytes(int T_spec, int T_text, int with_bits) {
  long long n = (long long)(2 + kRows) * T_text;
  if (with_bits) n += (long long)T_spec * ((T_text + 31) / 32 + 1);
  return n * 4;
}

// nc: [B, T_spec, T_text] f32 contiguous, already masked (-1e9 outside the
// mask); t_text_len, t_spec_len: [B] int32 on the device; path: [B, T_spec,
// T_text] f32, every cell written. scratch: null to keep the decision bits
// in shared memory, else [B, T_spec, ceil(T_text / 32) + 1] int32.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int mas_f32(const float* nc, const int* t_text_len,
                       const int* t_spec_len, float* path, unsigned* scratch,
                       int B, int T_spec, int T_text, void* stream) {
  if (B <= 0 || T_spec <= 0 || T_text <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)mas_shared_bytes(T_spec, T_text, scratch == nullptr);
  // above 48 KB the kernel must be allowed more dynamic shared memory: the
  // device's whole opt-in size, once per device
  static std::atomic<bool> allowed[kMaxDevices];
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!allowed[dev].load()) {
      int optin = 0;
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e != cudaSuccess) return (int)e;
      e = cudaFuncSetAttribute(mas_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
      if (e != cudaSuccess) return (int)e;
      allowed[dev].store(true);
    }
  }
  mas_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      nc, t_text_len, t_spec_len, path, scratch, T_spec, T_text);
  return (int)cudaGetLastError();
}
