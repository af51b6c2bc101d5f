// Word-level candidate selection of Q patterns, for Hopper (sm_90a).
//
// Replaces the XLA selection that the JAX pipeline runs in the same
// compiled program as its meta scan kernels: minima.select_words_tiles_q
// (sassy_tpu/ops/minima.py:662; select_words_tiles, :341, for one
// pattern). It computes what the port's plain version,
// minima.select_words_tiles_q_plain, computes: from the q1meta / q2meta
// outputs vp, vm, cost and meta ((Q, NW, T) words of uint32 bits), the end
// positions of every word whose screen bit (meta bit 0) is set that are
// rightmost local minima of cost <= k (or, with all_minima, every such
// position), as (4, N) int64 columns [pattern; tile; end position; cost].
// Per screened word, positions w*32 .. w*32 + 32 of the tile's window:
// column 0 stands only for the tile's boundary candidate (word 0 of a
// tile that owns position 0). With overhang, costs past the tile's text
// end add floor(float32(alpha) * float32(overshoot)), and the decreasing
// state is rebuilt over the n_prev words before the word from the
// overshoot-adjusted deltas, seeded by the meta code at the strip's start
// (else by the cross-tile seed state0).
//
// What bounds it on the H100: bytes. Every (pattern, word, tile) has its
// meta word read once; only the few screened words read vp, vm and cost
// (and the next word's and the strip's bits) and expand to 33 positions.
// At 1 GiB and 23 bp that is ~134 MB of meta for a handful of candidates.
//
// What the design does about it: the four arrays are contiguous, so the
// flat element f = (q * NW + w) * T + t is also its address. A block takes
// kWordsPerBlock consecutive elements, each thread every kSelThreads-th of
// them, so a warp reads 32 adjacent meta words at a time; an element that
// is not screened costs one load and one test, and only a screened one is
// decoded into (q, w, t). Many words per thread keep the blocks few: at
// one word per thread the blocks' own fixed cost, not the bytes, set the
// time. Two launches of the same grid: the first counts the candidates
// (at most 33 a word) and writes one sum per block; PyTorch's cumsum over
// the block sums and one host read of the total size the output; the
// second skips every block without a candidate and writes the candidates
// of each round of kSelThreads words at the block's offset plus the
// thread's exclusive prefix in the round, in the plain version's
// (pattern, word, tile, position) order. Built by
// sassy_tpu_torch/ops/myers_cuda.py with the scan kernels in one nvcc call.

#include "select_common.cuh"

namespace {

constexpr int kSelWarps = kSelThreads / 32;
constexpr int kWordsPerThread = 16;
constexpr int64_t kWordsPerBlock = kSelThreads * kWordsPerThread;

struct WordArgs {  // (Q, NW, T) arrays, contiguous
  const uint32_t* vp;
  const uint32_t* vm;
  const int32_t* cost;
  const int32_t* meta;
  const int32_t* valid_from;  // (T,) window-local owned range (vf, vt]
  const int32_t* valid_to;
  const int32_t* islast;    // (T,) window-local last text position, or -1
  const int64_t* pos_base;  // (T,) position of window position 0
  const int32_t* state0;    // (Q, T) cross-tile seeds, 1 = last delta +1
  const int64_t* text_end;  // (T,) window-local text end; null: no overhang
  float alpha;
  int n_prev;
  int Q, NW, T, k;
  bool all_minima;
  int32_t* block_counts;       // (blocks,) the first pass's output
  const int64_t* block_ends;   // (blocks,) their inclusive prefix sums
  int64_t* out;                // (4, N)
  int64_t N;
};

// The exclusive prefix sum of v over the block's threads in thread order;
// *total gets the block's sum. Every thread of the block calls it; the
// first barrier lets a block call it again in a loop.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kSelWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kSelWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < kSelWarps; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kSelWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  *total = warp_sums[kSelWarps - 1];
  return x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

// The candidates of flat element f = (q * NW + w) * T + t: their count,
// and with EMIT each written at out column o + i.
template <bool EMIT>
__device__ int word_candidates(const WordArgs& a, int64_t f, int64_t o) {
  if ((a.meta[f] & 1) == 0) return 0;
  const int64_t per_q = static_cast<int64_t>(a.NW) * a.T;
  const int q = static_cast<int>(f / per_q);
  const int64_t r = f - q * per_q;
  const int w = static_cast<int>(r / a.T);
  const int t = static_cast<int>(r - static_cast<int64_t>(w) * a.T);
  const int64_t at = f;
  const int64_t at_q = f - static_cast<int64_t>(w) * a.T;  // word 0 of (q, t)

  const uint32_t vp = a.vp[at];
  const uint32_t vm = a.vm[at];
  const int64_t vf = a.valid_from[t];
  const int64_t vt = a.valid_to[t];
  const int64_t il = a.islast[t];
  const bool over = a.text_end != nullptr;
  const int64_t tend = over ? a.text_end[t] : 0;
  const float alpha = a.alpha;
  auto ovf = [over, tend, alpha](int64_t p) -> int64_t {
    return over ? overshoot_floor(alpha, p - tend) : 0;
  };
  const int64_t w32 = static_cast<int64_t>(w) * 32;

  bool up = false;  // the last nonzero owned delta so far was +1
  if (!a.all_minima) {
    // the state at the strip's start: its meta code if an owned delta came
    // earlier in the tile, else the cross-tile seed; then the strip's
    // overshoot-adjusted deltas
    const int w0 = w - min(w, a.n_prev);
    const int code = (a.meta[at_q + static_cast<int64_t>(w0) * a.T] >> 1) & 3;
    up = code > 0 ? (code & 1) != 0
                  : a.state0[static_cast<int64_t>(q) * a.T + t] != 0;
    for (int ww = w0; ww < w; ++ww) {
      const int64_t at_w = at_q + static_cast<int64_t>(ww) * a.T;
      const uint32_t p = a.vp[at_w];
      const uint32_t m = a.vm[at_w];
      const int64_t l0 = static_cast<int64_t>(ww) * 32;
      for (int b = 0; b < 32; ++b) {
        const int64_t lp = l0 + b + 1;
        if (lp <= vf) continue;  // halo deltas are restart artifacts
        const int64_t d = bit_delta(p, m, b) + ovf(lp) - ovf(lp - 1);
        if (d != 0) up = d > 0;
      }
    }
  }

  int n = 0;
  auto take = [&](int j, int64_t c) {
    if (EMIT) {
      const int64_t i = o + n;
      a.out[i] = q;
      a.out[a.N + i] = t;
      a.out[2 * a.N + i] = a.pos_base[t] + w32 + j;
      a.out[3 * a.N + i] = c;
    }
    ++n;
  };

  // column j = position w32 + j; a candidate waits for the delta after it
  int64_t ov_prev = ovf(w32);
  int64_t raw_cost = a.cost[at];
  int64_t pend_cost = raw_cost + ov_prev;
  bool pend = w == 0 && vf < 0 && pend_cost <= a.k && (a.all_minima || !up);
  for (int j = 1; j <= 32; ++j) {
    const int64_t lp = w32 + j;
    const int raw = bit_delta(vp, vm, j - 1);
    const int64_t ov_j = ovf(lp);
    const int64_t d = raw + ov_j - ov_prev;
    if (pend && (a.all_minima || d >= 1 || lp - 1 == il)) take(j - 1, pend_cost);
    raw_cost += raw;
    const int64_t c = raw_cost + ov_j;
    if (!a.all_minima && lp > vf && d != 0) up = d > 0;
    pend = lp > vf && lp <= vt && c <= a.k && (a.all_minima || !up);
    pend_cost = c;
    ov_prev = ov_j;
  }
  if (pend) {
    bool ok = a.all_minima || w32 + 32 == il;
    if (!ok) {
      // the next word's first delta; an artificial +1 past the window
      int64_t next = 1;
      if (w + 1 < a.NW) {
        next = bit_delta(a.vp[at + a.T], a.vm[at + a.T], 0) +
               ovf(w32 + 33) - ovf(w32 + 32);
      }
      ok = next >= 1;
    }
    if (ok) take(32, pend_cost);
  }
  return n;
}

__global__ void __launch_bounds__(kSelThreads) count_words(const WordArgs a) {
  const int64_t F = static_cast<int64_t>(a.Q) * a.NW * a.T;
  const int64_t f0 = blockIdx.x * kWordsPerBlock + threadIdx.x;
  int n = 0;
  for (int i = 0; i < kWordsPerThread; ++i) {
    const int64_t f = f0 + i * kSelThreads;
    if (f < F) n += word_candidates<false>(a, f, 0);
  }
  int total;
  block_exclusive_scan(n, &total);
  if (threadIdx.x == 0) a.block_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kSelThreads) emit_words(const WordArgs a) {
  const int count = a.block_counts[blockIdx.x];
  if (count == 0) return;  // the whole block leaves: no barrier is split
  const int64_t F = static_cast<int64_t>(a.Q) * a.NW * a.T;
  const int64_t f0 = blockIdx.x * kWordsPerBlock + threadIdx.x;
  int64_t o = a.block_ends[blockIdx.x] - count;
  for (int i = 0; i < kWordsPerThread; ++i) {
    const int64_t f = f0 + i * kSelThreads;
    const int n = f < F ? word_candidates<false>(a, f, 0) : 0;
    int total;
    const int before = block_exclusive_scan(n, &total);
    if (n > 0) word_candidates<true>(a, f, o + before);
    o += total;
  }
}

}  // namespace

// The (pattern, word, tile) elements per block: the caller sizes
// block_counts as ceil(Q * NW * T / this).
extern "C" long long sassy_select_words_per_block() { return kWordsPerBlock; }

// pass 0 counts (block_counts), pass 1 writes `out` (block_counts and
// their inclusive prefix sums block_ends from pass 0). Launches on
// `stream` without synchronising; returns the cudaError_t of the launch.
extern "C" int sassy_select_words(
    const void* vp, const void* vm, const void* cost, const void* meta,
    const void* valid_from, const void* valid_to, const void* islast,
    const void* pos_base, const void* state0, const void* text_end,
    void* block_counts, const void* block_ends, void* out, long long N,
    int Q, int NW, int T, int k, int all_minima,
    int n_prev, float alpha, int pass, void* stream) {
  WordArgs a = {};
  a.vp = static_cast<const uint32_t*>(vp);
  a.vm = static_cast<const uint32_t*>(vm);
  a.cost = static_cast<const int32_t*>(cost);
  a.meta = static_cast<const int32_t*>(meta);
  a.valid_from = static_cast<const int32_t*>(valid_from);
  a.valid_to = static_cast<const int32_t*>(valid_to);
  a.islast = static_cast<const int32_t*>(islast);
  a.pos_base = static_cast<const int64_t*>(pos_base);
  a.state0 = static_cast<const int32_t*>(state0);
  a.text_end = static_cast<const int64_t*>(text_end);
  a.alpha = alpha;
  a.n_prev = n_prev;
  a.Q = Q;
  a.NW = NW;
  a.T = T;
  a.k = k;
  a.all_minima = all_minima != 0;
  a.block_counts = static_cast<int32_t*>(block_counts);
  a.block_ends = static_cast<const int64_t*>(block_ends);
  a.out = static_cast<int64_t*>(out);
  a.N = N;
  const long long F = static_cast<long long>(Q) * NW * T;
  const long long blocks = (F + kWordsPerBlock - 1) / kWordsPerBlock;
  if (F <= 0 || blocks > 0x7FFFFFFFLL || n_prev < 0 || pass < 0 || pass > 1 ||
      (pass == 1 && (block_ends == nullptr || out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pass == 0) {
    count_words<<<static_cast<unsigned>(blocks), kSelThreads, 0, s>>>(a);
  } else {
    emit_words<<<static_cast<unsigned>(blocks), kSelThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
