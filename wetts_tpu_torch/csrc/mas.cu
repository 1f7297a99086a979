// K2: monotonic alignment search (MAS) in one launch: the lengths from the
// mask, the -1e9 fill, the forward dynamic programme, backtracking and the
// masked 0/1 path.
//
// Replaces wetts_tpu/ops/mas_pallas.py:maximum_path_pallas (body _mas_kernel)
// together with the JAX wrapper around it: the Pallas TPU kernel keeps the
// f32 DP table of 8 utterances in VMEM and replaces gathers by one-hot sums.
// Per utterance, with m the mask, nc = neg_cent * m + (1 - m) * -1e9 and
// lengths t_text = max(1, floor(sum m[0, :])), t_spec = max(1, floor(sum
// m[:, 0])):
//
//   v[y, x] = nc[y, x] + max(left, up)
//     left = v[y-1, x-1]   (x == 0: 0 at y == 0, else -1e9)
//     up   = v[y-1, x]     (x == y: -1e9)            v[-1, :] = -1e9
//
// then from (t_spec - 1, t_text - 1) upwards: row y takes column `index`,
// and index steps left when index > 0 and (index == y or
// v[y-1, index] < v[y-1, index-1]). The output is m at (y, index) for rows
// y < t_spec, and 0 elsewhere.
//
// Bit-exactness: the fill is the JAX expression, product by product
// (__fmul_rn, __fsub_rn, __fadd_rn: nothing contracts into an fma); one
// __fadd_rn and one fmaxf per cell, in the order above; the strict `<` on
// the same two table values the TPU kernel compares. The length sums are
// taken in another order than PyTorch's, which is exact for masks of 0s and
// 1s (the outer product of two sequence masks, all the model makes). A zero
// of the path is written as +0, where path * mask gives -0 for a negative
// mask value (equal under ==).
//
// What bounds it on the H100: the chain of rows, more than bytes or
// operations. The bytes (the valid cells of scores and mask read once,
// every cell of the path written once) take 2-20 us at the card's memory
// rate over the v1 training shapes, a dependent fmaxf and fadd per row
// 1.6-4 us at the maximum SM clock, the operations less. But each
// utterance is t_spec dependent rows, a batch of 32 utterances fills 32 of
// the 132 SMs, and a row's step is that fmaxf and fadd behind a shuffle
// and the row's loads. So a row must be short, and everything else must
// stay off the chain of rows:
// - one block per utterance, one launch per call: the lengths, the fill
//   and the final `* mask` are done here, and nothing waits for the host;
// - DP warps hold the DP row in registers, 32 J columns a warp, lanes
//   interleaved (column x0 + 32 j + lane in slot j). A row's step per slot
//   is a rotation by one lane (__shfl_sync, whose latency is most of it),
//   a select, one fmaxf and one __fadd_rn, with no barrier. Each slot's
//   __ballot_sync of the decisions is then exactly one 32-column word of
//   the row's bitmap, which the walk reads as it is;
//   consecutive runs per lane would shuffle once per J rows, but need the
//   bits packed across lanes and a walk over a strided layout. J is the
//   fewest columns that keep a block at 8 DP warps: two J = 1 warps on a
//   scheduler hide each other's shuffle latency, where one warp of J = 2
//   issues in order and stalls on each slot in turn (on the H100 it took
//   more than twice as long a row);
// - the row loop is straight-line code over a chunk of 32 or 16 rows, the
//   next row's scores loaded before the current row's step: a check of the
//   row count inside it kept those loads behind it;
// - the dependency runs only rightwards (a cell reads the row above, at
//   its own column and the one to its left), so warp w needs one value a
//   row from warp w - 1, its last column. Warp w - 1 stores it with its row
//   number in one 64-bit word, and warp w polls those tags, once a chunk
//   when a block has at most 4 DP warps, every 8 rows past that (warp w
//   then trails warp w - 1 by 8 rows and not by a chunk). No barrier and
//   no back-pressure: the slots live in the ring stage of their rows, and
//   the producer refills a stage only when every DP warp has released it
//   (a named barrier of the pair's 64 threads, tried first, made both
//   warps meet at every hand-over, so that neither could run ahead);
// - a producer warp keeps the scores and the mask of the next chunks in
//   flight into a ring of shared memory, one bulk copy (cp.async.bulk)
//   per array and chunk of the rows' 16-byte granules, completing on an
//   mbarrier per stage; it sleeps while it waits, so as not to take issue
//   slots from the DP warp on its scheduler. Copies of 4 bytes a thread
//   (cp.async) could not keep up;
// - writer warps write the zeros of the whole [T_spec, T_text] path while
//   the DP runs; a block barrier after the walk orders the t_spec ones
//   behind them, so the output costs the chain nothing but those stores;
// - the decision bits stay in shared memory where they fit, else in the
//   wrapper's scratch buffer. Backtracking is one warp, 32 rows a round:
//   the index falls by at most 1 a row, so each lane builds its row's
//   decisions at columns index - d as bit d of one word (two words of the
//   bitmap, bit-reversed), and the round's 32 steps run from registers,
//   a shift, an and and an add each.

#include <cuda_runtime.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int KB = 32;            // most rows a ring stage (a chunk) holds
constexpr int G = 8;              // rows handed over at once past 4 warps
constexpr int kMaxDp = 16;        // DP warps (8 below J = 8: pick_j)
constexpr int kWriters = 2;       // writer warps (zeros of the path)
constexpr int kMaxThreads = 32 * (kMaxDp + 1 + kWriters);
constexpr int kMaxStages = 16;
constexpr int kWantStages = 6;    // fewer: the bits go to the scratch
constexpr long long kSmemBudget = 200 * 1024;
constexpr int kMaxDevices = 64;

// header: mbarriers full[kMaxStages], empty[kMaxStages]; the lengths and
// the warps' partial sums
constexpr int kBarBytes = 2 * kMaxStages * 8;
constexpr int kRedBytes = 2 * 4 + 2 * (kMaxThreads / 32) * 4;
constexpr int kHeaderBytes = (kBarBytes + kRedBytes + 15) / 16 * 16;

__host__ __device__ inline long long round16(long long n) {
  return (n + 15) & ~15LL;
}

__host__ __device__ inline int words_of(int T_text) {
  return (T_text + 31) / 32;
}

// bytes of one ring stage for `kb` rows: the rows of scores, then of the
// mask, each as the 16-byte granules that cover them (the bulk copy's
// unit), then the hand-over slots of each pair of neighbouring DP warps
__host__ __device__ inline long long span_bytes(int kb, int T_text,
                                                int elem) {
  return round16((long long)kb * T_text * elem) + 16;
}
__host__ __device__ inline long long stage_bytes(int kb, int T_text,
                                                 int mask_bytes,
                                                 int dp_warps) {
  return span_bytes(kb, T_text, 4) + span_bytes(kb, T_text, mask_bytes) +
         (long long)(dp_warps - 1) * KB * 8;
}

// columns per DP warp: 32 * J, the fewest that keep a block at 8 DP warps
// (two on each of the SM's four schedulers) up to 2048 columns; wider text
// takes up to kMaxDp warps of 256 columns
inline int pick_j(int T_text) {
  const int w = words_of(T_text);
  return w <= 8 ? 1 : w <= 16 ? 2 : w <= 32 ? 4 : 8;
}

struct Plan {
  int J, dp_warps, kb, stages, bits_in_smem;
  long long smem;
};

// the launch's shape: rows a stage, ring stages, where the decision bits
// live; false when T_text is too wide for the kernel
bool make_plan(int T_spec, int T_text, int mask_bytes, Plan* p) {
  p->J = pick_j(T_text);
  p->dp_warps = (words_of(T_text) + p->J - 1) / p->J;
  if (p->dp_warps > kMaxDp) return false;
  const long long bits = round16((long long)T_spec * (words_of(T_text) + 1)
                                 * 4);
  const long long room = kSmemBudget - kHeaderBytes;
  // warp w starts a chunk when warp w - 1 has finished it: more than 4 DP
  // warps take chunks of 16 rows, so that the skew stays short
  for (int kb = p->dp_warps <= 4 ? KB : KB / 2; kb >= 1; kb /= 2) {
    const long long stage = stage_bytes(kb, T_text, mask_bytes,
                                        p->dp_warps);
    const int chunks = (T_spec + kb - 1) / kb;
    const int cap = chunks < 2 ? 2 : chunks < kMaxStages ? chunks
                                                         : kMaxStages;
    long long fit = (room - bits) / stage;
    int in_smem = 1;
    if (fit < kWantStages && fit < cap) {
      in_smem = 0;
      fit = room / stage;
    }
    if (fit < 3 && fit < cap && kb > 1) continue;  // fewer rows a stage
    if (fit < 2) return false;
    p->kb = kb;
    p->bits_in_smem = in_smem;
    p->stages = (int)(fit < cap ? fit : cap);
    p->smem = kHeaderBytes + p->stages * stage + (in_smem ? bits : 0);
    return true;
  }
  return false;
}

struct Args {
  const float* nc;     // [B, T_spec, T_text] f32 contiguous
  const void* mask;    // the same shape, f32 or bool (1 byte)
  float* path;         // [B, T_spec, T_text] f32, every cell written
  unsigned* scratch;   // [B, T_spec, W + 1] or null
  int T_spec, T_text, W, kb, stages, bits_in_smem;
};

template <typename M>
__device__ __forceinline__ float mask_value(M v) {
  if constexpr (sizeof(M) == 1) return v ? 1.0f : 0.0f;
  else return v;
}

// the JAX fill: nc * m + (1 - m) * -1e9, each operation rounded
__device__ __forceinline__ float fill(float nc, float m) {
  return __fadd_rn(__fmul_rn(nc, m), __fmul_rn(__fsub_rn(1.0f, m), kNeg));
}

// `value` to shared memory at `addr` where `p` holds, as one predicated
// 64-bit store: no branch, so the warp never splits around it
__device__ __forceinline__ void store_if(bool p, uint32_t addr,
                                         unsigned long long value) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %0, 0;\n"
      "@q st.volatile.shared.u64 [%1], %2;\n}\n"
      :: "r"((int)p), "r"(addr), "l"(value));
}

// the 16-byte granules that hold `bytes` bytes from `p`: (first, size)
__device__ __forceinline__ void granules(const void* p, size_t bytes,
                                         size_t* first, uint32_t* size) {
  const size_t a = reinterpret_cast<size_t>(p);
  *first = a & ~(size_t)15;
  *size = (uint32_t)(((a + bytes + 15) & ~(size_t)15) - *first);
}

// what a DP warp's row step needs besides the row's data
struct Row {
  int x0, lane, T_text, t_text;
  bool has_left, has_right;
};

// `rows` rows of the forward DP from the stage at ncs / ms (row 0 at y0):
// v[] carries the DP row, mine[] collects the decision words (row r and
// slot j with lane r J + j), own receives the last column for the right
// neighbour; the left neighbour's last column arrives in left_slots and hv
// (row y0 + lane), H rows at a time, and carry holds its row y0 - 1. N
// rows at most; TAIL: rows may be fewer than N.
template <int J, int N, int H, bool TAIL, typename M>
__device__ __forceinline__ void dp_chunk(
    const Row& w, float (&v)[J], unsigned (&mine)[(KB * J + 31) / 32],
    const float* ncs, const M* ms, const int (&xl)[J], int y0, int rows,
    int kb, float carry, float& hv,
    const volatile unsigned long long* left_slots, uint32_t own) {
  const int lane = w.lane;
  float sc[J];
#pragma unroll
  for (int j = 0; j < J; ++j)
    sc[j] = w.x0 + 32 * j + lane < w.t_text
                ? fill(ncs[xl[j]], mask_value(ms[xl[j]]))
                : kNeg;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    if (TAIL && r >= rows) break;  // uniform across the warp
    const int y = y0 + r;
    if (w.has_left && r % H == 0) {
      // rows y .. y + H - 1 of the left neighbour, lane i holding row
      // y0 + i: written as {value, row} in one 64-bit store, so a slot is
      // ready when it holds its row
      const bool wanted = lane >= r && lane < r + H && lane < rows;
      unsigned long long got = wanted ? left_slots[lane] : 0;
      unsigned long long since = 0;
      const unsigned want = (unsigned)(y0 + lane);
      for (uint32_t spins = 1;
           !__all_sync(kFull, !wanted || (unsigned)(got >> 32) == want);
           ++spins) {
        if ((spins & 1023) == 0) trap_if_stuck(&since);
        got = wanted ? left_slots[lane] : 0;
      }
      if (wanted) hv = __uint_as_float((unsigned)got);
    }
    // the next row's scores, loaded before this row's step (a row of this
    // stage, so also past the chunk's end)
    const int rn = (TAIL ? min(r + 1, kb - 1) : min(r + 1, N - 1))
                   * w.T_text;
    float nc_n[J], m_n[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      nc_n[j] = ncs[rn + xl[j]];
      m_n[j] = mask_value(ms[rn + xl[j]]);
    }
    const float prev_edge = __shfl_sync(kFull, hv, r > 0 ? r - 1 : 0);
    const float edge = w.has_left ? (r == 0 ? carry : prev_edge)
                                  : (y == 0 ? 0.0f : kNeg);
    float rot[J];
#pragma unroll
    for (int j = 0; j < J; ++j)
      rot[j] = __shfl_sync(kFull, v[j], (lane + 31) & 31);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int x = w.x0 + 32 * j + lane;
      const float left = lane > 0 ? rot[j] : (j > 0 ? rot[j - 1] : edge);
      const float up_raw = v[j];
      const float up = x == y ? kNeg : up_raw;
      v[j] = __fadd_rn(sc[j], fmaxf(left, up));
      // the decision word of this row and slot, kept by lane r J + j
      const unsigned word = __ballot_sync(kFull, x == y || up_raw < left);
      if (lane == (r * J + j) % 32) mine[(r * J + j) / 32] = word;
    }
    store_if(w.has_right && lane == 31, own + 8 * r,
             ((unsigned long long)(unsigned)y << 32) |
                 __float_as_uint(v[J - 1]));
#pragma unroll
    for (int j = 0; j < J; ++j)
      sc[j] = w.x0 + 32 * j + lane < w.t_text ? fill(nc_n[j], m_n[j]) : kNeg;
  }
}

// threads a block of the J instance has at most
template <int J>
constexpr int max_threads() {
  return 32 * ((J < 8 ? kMaxDp / 2 : kMaxDp) + 1 + kWriters);
}

template <int J, typename M>
__global__ void __launch_bounds__(max_threads<J>(), 1) mas_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int dp_warps = n_warps - 1 - kWriters;
  const int T_spec = a.T_spec, T_text = a.T_text, W = a.W, S = a.stages;
  const int kb = a.kb;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  int* lens = reinterpret_cast<int*>(smem + kBarBytes);
  float* red = reinterpret_cast<float*>(lens + 2);  // [2][n_warps]
  unsigned char* ring = smem + kHeaderBytes;
  const long long nc_span = span_bytes(kb, T_text, 4);
  const long long hand_at = nc_span + span_bytes(kb, T_text, sizeof(M));
  const long long stage = stage_bytes(kb, T_text, sizeof(M), dp_warps);
  unsigned* bits;
  if (a.bits_in_smem) {
    bits = reinterpret_cast<unsigned*>(ring + S * stage);
  } else {
    bits = a.scratch + (size_t)b * T_spec * (W + 1);
  }
  int* index_of = reinterpret_cast<int*>(bits + (size_t)T_spec * W);

  const size_t cells = (size_t)T_spec * T_text;
  const float* nc_b = a.nc + (size_t)b * cells;
  const M* mask_b = static_cast<const M*>(a.mask) + (size_t)b * cells;
  float* path_b = a.path + (size_t)b * cells;

  // ---- the lengths: sums of the mask's row 0 and column 0 ----
  {
    float sx = 0.0f, sy = 0.0f;
    for (int i = tid; i < T_text; i += blockDim.x)
      sx += mask_value(mask_b[i]);
    for (int i = tid; i < T_spec; i += blockDim.x)
      sy += mask_value(mask_b[(size_t)i * T_text]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sx += __shfl_xor_sync(kFull, sx, o);
      sy += __shfl_xor_sync(kFull, sy, o);
    }
    if (lane == 0) {
      red[warp] = sx;
      red[n_warps + warp] = sy;
    }
    __syncthreads();
    if (tid == 0) {
      float tx = 0.0f, ty = 0.0f;
      for (int w = 0; w < n_warps; ++w) {
        tx += red[w];
        ty += red[n_warps + w];
      }
      // truncation toward zero, as .to(int32), then clamped to [1, T]
      lens[0] = min(max((int)tx, 1), T_text);
      lens[1] = min(max((int)ty, 1), T_spec);
    }
    __syncthreads();
  }
  const int t_text = lens[0], t_spec = lens[1];
  const int d_active = min(dp_warps, (t_text + 32 * J - 1) / (32 * J));
  const int n_chunks = (t_spec + kb - 1) / kb;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_addr(full + s), 1);
      mbar_init(smem_addr(empty + s), d_active);
    }
    mbar_init_fence();
  }
  // no hand-over slot holds a row yet
  for (int i = tid; i < S * (dp_warps - 1) * KB; i += blockDim.x) {
    const int st = i / ((dp_warps - 1) * KB);
    reinterpret_cast<unsigned long long*>(ring + st * stage + hand_at)[
        i - st * (dp_warps - 1) * KB] = ~0ull;
  }
  __syncthreads();

  if (warp < dp_warps) {
    // ---- forward DP: columns x0 + 32 j + lane ----
    const int x0 = warp * 32 * J;
    if (warp < d_active) {
      float v[J];
#pragma unroll
      for (int j = 0; j < J; ++j) v[j] = kNeg;
      const bool has_left = warp > 0, has_right = warp + 1 < d_active;
      float carry = kNeg;  // v[y-1, x0-1] for the chunk's first row
      // the columns this lane loads, kept inside the row
      int xl[J];
#pragma unroll
      for (int j = 0; j < J; ++j) xl[j] = min(x0 + 32 * j + lane, T_text - 1);
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % S;
        const int y0 = c * kb, rows = min(kb, t_spec - y0);
        const unsigned char* st = ring + s * stage;
        // the left neighbour's hand-over slots of this stage (row y0 + i
        // in slot i)
        const volatile unsigned long long* left_slots =
            reinterpret_cast<const volatile unsigned long long*>(
                st + hand_at) + (has_left ? (warp - 1) * KB : 0);
        const uint32_t own =
            smem_addr(st + hand_at) + 8u * (uint32_t)(warp * KB);
        mbar_wait(smem_addr(full + s), (c / S) & 1);
        const float* ncs = reinterpret_cast<const float*>(
            st + (reinterpret_cast<size_t>(nc_b + (size_t)y0 * T_text)
                  & 15));
        const M* ms = reinterpret_cast<const M*>(
            st + nc_span +
            (reinterpret_cast<size_t>(mask_b + (size_t)y0 * T_text) & 15));
        unsigned mine[(KB * J + 31) / 32];
        const Row row{x0, lane, T_text, t_text, has_left, has_right};
        float hv = kNeg;
        // a whole chunk of 32 or 16 rows runs straight through; a check of
        // the row count would keep the next row's loads and fill behind it.
        // Chunks of 32 rows (at most 4 DP warps) are handed over whole,
        // those of 16 rows G rows at a time, so that warp w trails warp
        // w - 1 by G rows and not by a chunk
        if (rows == KB)
          dp_chunk<J, KB, KB, false>(row, v, mine, ncs, ms, xl, y0, KB, kb,
                                     carry, hv, left_slots, own);
        else if (rows == KB / 2)
          dp_chunk<J, KB / 2, G, false>(row, v, mine, ncs, ms, xl, y0,
                                        KB / 2, kb, carry, hv, left_slots,
                                        own);
        else
          dp_chunk<J, KB, G, true>(row, v, mine, ncs, ms, xl, y0, rows, kb,
                                   carry, hv, left_slots, own);
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_addr(empty + s));
        // the chunk's decision words: row y0 + i / J, slot i % J
#pragma unroll
        for (int h = 0; h < (KB * J + 31) / 32; ++h) {
          const int i = 32 * h + lane;
          const int r = i / J, j = i % J;
          if (r < rows && warp * J + j < W)
            bits[(size_t)(y0 + r) * W + warp * J + j] = mine[h];
        }
        if (has_left) carry = __shfl_sync(kFull, hv, rows - 1);
      }
    }
  } else if (warp == dp_warps) {
    // ---- producer: scores and mask of chunk c into stage c % S ----
    if (lane == 0) {
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % S;
        if (c >= S) mbar_wait(smem_addr(empty + s), ((c / S) - 1) & 1, 200);
        const int y0 = c * kb, rows = min(kb, t_spec - y0);
        size_t nc_first, m_first;
        uint32_t nc_size, m_size;
        granules(nc_b + (size_t)y0 * T_text, (size_t)rows * T_text * 4,
                 &nc_first, &nc_size);
        granules(mask_b + (size_t)y0 * T_text,
                 (size_t)rows * T_text * sizeof(M), &m_first, &m_size);
        const uint32_t bar = smem_addr(full + s);
        const uint32_t dst = smem_addr(ring + s * stage);
        mbar_arrive_expect_tx(bar, nc_size + m_size);
        bulk_copy(dst, reinterpret_cast<const void*>(nc_first), nc_size,
                  bar);
        bulk_copy(dst + (uint32_t)nc_span,
                  reinterpret_cast<const void*>(m_first), m_size, bar);
      }
    }
  } else {
    // ---- writers: the zeros of the whole path, under the DP ----
    const int z = tid - 32 * (dp_warps + 1);
    const int nz = 32 * kWriters;
    size_t head = ((16 - (reinterpret_cast<size_t>(path_b) & 15)) & 15) / 4;
    if (head > cells) head = cells;
    for (size_t i = z; i < head; i += nz) path_b[i] = 0.0f;
    float4* body = reinterpret_cast<float4*>(path_b + head);
    const size_t n4 = (cells - head) / 4;
    for (size_t i = z; i < n4; i += nz)
      body[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (size_t i = head + 4 * n4 + z; i < cells; i += nz) path_b[i] = 0.0f;
  }
  __syncthreads();  // every row's decision bits, and the zeros, are done

  // ---- backtracking: warp 0, 32 rows a round ----
  if (warp == 0) {
    int index = t_text - 1;
    for (int top = t_spec - 1; top >= 0; top -= 32) {
      // lane k: row top - k's decisions at columns index - d, as bit d
      // (d < 32: the index falls by at most 1 a row), cleared where no
      // step is allowed (row 0, column 0 and left of it)
      const int yk = top - lane;
      const int bw = max((index >> 5) - 1, 0);
      unsigned steps = 0;
      if (yk > 0) {
        const unsigned lo = bits[(size_t)yk * W + bw];
        const unsigned hi = bw + 1 < W ? bits[(size_t)yk * W + bw + 1] : 0u;
        const unsigned long long window =
            ((unsigned long long)hi << 32) | lo;
        const int p = index - 32 * bw;  // the index's bit in the window
        const unsigned seg = p >= 31 ? (unsigned)(window >> (p - 31))
                                     : (unsigned)(window << (31 - p));
        steps = __brev(seg);
        if (index < 32) steps &= (1u << index) - 1u;
      }
      // the round's 32 steps from registers: d is how far the index has
      // fallen in the round, and row k steps where its bit d is set
      int d = 0, at = 0;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const unsigned sk = __shfl_sync(kFull, steps, k);
        if (lane == k) at = index - d;
        d += (sk >> d) & 1u;
      }
      if (yk >= 0) index_of[yk] = at;
      index -= d;
    }
  }
  __syncthreads();

  // ---- the ones: 1 * m at each valid row's column ----
  for (int y = tid; y < t_spec; y += blockDim.x) {
    const size_t i = (size_t)y * T_text + index_of[y];
    path_b[i] = mask_value(mask_b[i]);
  }
}

template <int J, typename M>
int launch(const Args& args, const Plan& plan, int B, cudaStream_t stream) {
  // above 48 KB the kernel must be allowed more dynamic shared memory: the
  // device's whole opt-in size, once per device and instance
  static std::atomic<bool> allowed[kMaxDevices];
  if (plan.smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!allowed[dev].load()) {
      int optin = 0;
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e != cudaSuccess) return (int)e;
      e = cudaFuncSetAttribute(mas_kernel<J, M>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
      if (e != cudaSuccess) return (int)e;
      allowed[dev].store(true);
    }
  }
  const int threads = 32 * (plan.dp_warps + 1 + kWriters);
  mas_kernel<J, M><<<B, threads, plan.smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename M>
int dispatch(const Args& args, const Plan& plan, int B, cudaStream_t s) {
  switch (plan.J) {
    case 1: return launch<1, M>(args, plan, B, s);
    case 2: return launch<2, M>(args, plan, B, s);
    case 4: return launch<4, M>(args, plan, B, s);
    default: return launch<8, M>(args, plan, B, s);
  }
}

}  // namespace

// Words of scratch per utterance that a [*, T_spec, T_text] launch needs
// for its decision bits (0: they fit in shared memory), or -1 when T_text
// is too wide for the kernel. mask_bytes: 4 (f32) or 1 (bool).
extern "C" long long mas_scratch_words(int T_spec, int T_text,
                                       int mask_bytes) {
  Plan plan;
  if (T_spec <= 0 || T_text <= 0 || !make_plan(T_spec, T_text, mask_bytes,
                                               &plan))
    return -1;
  return plan.bits_in_smem ? 0 : (long long)T_spec * (words_of(T_text) + 1);
}

// nc: [B, T_spec, T_text] f32 contiguous, the raw scores; mask: the same
// shape, contiguous, f32 (mask_bytes 4) or bool (mask_bytes 1); path:
// [B, T_spec, T_text] f32, every cell written. scratch: null, or B *
// mas_scratch_words(...) int32 where that is not 0. Rows are copied as the
// 16-byte granules that hold them, so up to 15 bytes around nc and mask
// are read (inside PyTorch's allocations, which are 512-byte granular).
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int mas(const float* nc, const void* mask, int mask_bytes,
                   float* path, unsigned* scratch, int B, int T_spec,
                   int T_text, void* stream) {
  Plan plan;
  if (B <= 0 || T_spec <= 0 || T_text <= 0 ||
      (mask_bytes != 4 && mask_bytes != 1) ||
      !make_plan(T_spec, T_text, mask_bytes, &plan) ||
      (!plan.bits_in_smem && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args args{nc,     mask,          path,
                  scratch, T_spec,        T_text,
                  words_of(T_text), plan.kb, plan.stages,
                  plan.bits_in_smem};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mask_bytes == 4 ? dispatch<float>(args, plan, B, s)
                         : dispatch<unsigned char>(args, plan, B, s);
}
