// Word-level candidate selection of Q patterns, the state chain across
// tiles inside, for Hopper (sm_90a).
//
// Replaces the XLA selection that the JAX pipeline runs in the same
// compiled program as its meta scan kernels: minima.select_words_tiles_q
// (sassy_tpu/ops/minima.py:662; select_words_tiles, :341, for one
// pattern), with the state chain before it (minima.tile_state_chain_codes
// from the kernels' final codes). It computes what the port's plain
// versions compute (minima.select_words_chained_plain: the chain, then
// select_words_tiles_q_plain; or, given each tile's state, the latter
// alone): from the q1meta / q2meta outputs vp, vm, cost and meta ((Q, NW,
// T) words of uint32 bits) and final ((Q, T), each tile's last owned
// delta), the end positions of every word whose screen bit (meta bit 0)
// is set that are rightmost local minima of cost <= k (or, with
// all_minima, every such position), as (4, N) int64 columns [pattern;
// tile; end position; cost], and the state code carried out of each
// pattern's last tile. Per screened word, positions w*32 .. w*32 + 32 of
// the tile's window: column 0 stands only for the tile's boundary
// candidate. With overhang, costs past the tile's text end add
// floor(float32(alpha) * float32(overshoot)), and the decreasing state is
// rebuilt over the n_prev words before the word from the
// overshoot-adjusted deltas, seeded by the meta code at the strip's start
// (else by the tile's entering state, the chain's). The grid, the
// per-element work and the chain are in select_words.cuh.
//
// What bounds it on the H100: bytes. Every (pattern, word, tile) has its
// meta word read once, every (pattern, tile) its final code; only the few
// screened words read vp, vm and cost (and the next word's and the
// strip's bits) and expand to 33 positions. At 1 GiB and 23 bp that is
// ~134 MB of meta for a handful of candidates.
//
// What the design does about it: three launches around one 8-byte host
// read, no PyTorch op between them. A tile's entering state matters only
// to a screened word with no owned delta before it in the tile (its
// strip's meta code is 0), and such words are rare.
// 1. count: each block's elements lie side by side in memory; each thread
//    issues the loads of all its kWordsPerThread meta words at once (a
//    warp reads 32 adjacent words each round) and notes the screened
//    ones. Only a block
//    with a word that needs the state, or the first block of a segment,
//    composes the segment's tile maps in shared memory (each thread a run
//    of tiles, then a block scan of the maps); the first writes the
//    segment's map. The screened words are counted for both states the
//    segment may be entered with, summed over the block.
// 2. scan, one block: the segments' maps composed in order (each pattern
//    from its carry) give every segment its entering state and each
//    pattern's carry out; then each block's count for its segment's state,
//    summed in order, gives its output offset and the total.
// 3. emit: a block with candidates composes its segment's maps again only
//    if it must, and writes each round of kSelThreads elements' candidates
//    at its offset plus the thread's exclusive prefix in the round, in the
//    plain version's (pattern, word, tile, position) order, no atomics.
// The wrapper (ops/myers_cuda.py) reads the total after launch 2 to size
// the output. Built by sassy_tpu_torch/ops/myers_cuda.py with the scan
// kernels in one nvcc call.

#include "select_words.cuh"

namespace {

constexpr int kScanThreads = 1024;

__device__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

struct AddOp {
  template <class V>
  __device__ V operator()(V a, V b) const { return a + b; }
};

struct MapOp {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return map_then(a, b);
  }
};

// The composition, by op (earlier, later), of the block's earlier
// threads' values in thread order (identity for thread 0); *all gets the
// whole block's. Every thread of the block calls it; the first barrier
// lets a block call it again.
template <class V, class Op>
__device__ V block_exclusive(V mine, V identity, Op op, V* all) {
  __shared__ V smem[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  __syncthreads();
  V inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const V o = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc = op(o, inc);
  }
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    V w = lane < warps ? smem[lane] : identity;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const V o = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w = op(o, w);
    }
    if (lane < warps) smem[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  V ex = __shfl_up_sync(0xFFFFFFFFu, inc, 1);
  if (lane == 0) ex = identity;
  if (warp > 0) ex = op(smem[warp - 1], ex);
  *all = smem[warps - 1];
  return ex;
}

// Block part p's segment: each tile's entering map (from the segment's
// entering state) into rel, each thread composing a run of tiles; returns
// the segment's map. Every thread of the block calls it.
__device__ uint32_t segment_chain(const WordArgs& a, const Part& p,
                                  uint8_t* rel) {
  const int per = (p.width() + kSelThreads - 1) / kSelThreads;
  const int ta = p.t0 + min(static_cast<int>(threadIdx.x) * per, p.width());
  const int tb = min(ta + per, p.t1);
  const uint32_t run = chain_run(a, p.q, ta, tb, kIdentity, nullptr, 0);
  uint32_t all;
  const uint32_t ex = block_exclusive(run, kIdentity, MapOp(), &all);
  chain_run(a, p.q, ta, tb, ex, rel, p.t0);
  __syncthreads();
  return all;
}

// The block's screened elements (bit i: the thread's element of round i),
// and whether one of them needs its tile's state. The rounds' loads are
// independent, so all of a thread's are in flight at once.
__device__ uint32_t screened(const WordArgs& a, const Part& p, bool* need) {
  const int n = p.elems();
  uint32_t mask = 0;
#pragma unroll
  for (int i = 0; i < kWordsPerThread; ++i) {
    const int e = threadIdx.x + i * kSelThreads;
    if (e < n && (a.meta[p.base + e] & 1)) mask |= 1u << i;
  }
  bool any = false;
  for (uint32_t m = mask; m != 0; m &= m - 1) {
    const int i = __ffs(m) - 1;
    any = any || needs_state(a, p.base + threadIdx.x + i * kSelThreads);
  }
  *need = any;
  return mask;
}

// Launch 1: each block's candidates for both entering states of its
// segment; each segment's map.
__global__ void __launch_bounds__(kSelThreads)
    count_words(const WordArgs a, const Grid g, WordScratch sc) {
  __shared__ uint8_t rel[kBlockElems];
  const Part p = part_of(g, blockIdx.x);
  bool need;
  const uint32_t mask = screened(a, p, &need);
  const bool first = p.w0 == 0;  // the segment's first block
  uint32_t seg_map = kIdentity;
  if (__syncthreads_or(need) || (first && !a.all_minima)) {
    seg_map = segment_chain(a, p, rel);
  }
  int n[2] = {0, 0};
  for (uint32_t m = mask; m != 0; m &= m - 1) {
    const int e = threadIdx.x + (__ffs(m) - 1) * kSelThreads;
    const int64_t f = p.base + e;
    const uint32_t r = needs_state(a, f) ? rel[elem_tile(p, e)] : 0u;
    const int n0 = count_at(a, f, r, 0);
    n[0] += n0;
    n[1] += map_at(r, 0) == map_at(r, 1) ? n0 : count_at(a, f, r, 1);
  }
  int64_t total;
  block_exclusive(pack_counts(n[0], n[1]), int64_t{0}, AddOp(), &total);
  if (threadIdx.x == 0) {
    sc.counts[blockIdx.x] = total;
    if (first) sc.segs[2 * p.seg] = static_cast<int32_t>(seg_map);
  }
}

// Launch 2, one block: each segment's entering state and each pattern's
// carry out; each block's offset, and the total.
__global__ void __launch_bounds__(kScanThreads)
    scan_words(const WordArgs a, const Grid g, WordScratch sc,
               int32_t* carry_out) {
  const int64_t S = g.segments();
  const int64_t per = (S + kScanThreads - 1) / kScanThreads;
  const int64_t s0 = min64(static_cast<int64_t>(threadIdx.x) * per, S);
  const int64_t s1 = min64(s0 + per, S);
  uint32_t run = kIdentity;
  for (int64_t s = s0; s < s1; ++s) {
    run = map_then(run, segment_elem(a, g, s, sc.segs[2 * s]));
  }
  uint32_t all;
  uint32_t ex = block_exclusive(run, kIdentity, MapOp(), &all);
  for (int64_t s = s0; s < s1; ++s) {
    const int q = static_cast<int>(s / g.XB);
    const uint32_t m = sc.segs[2 * s];
    const int in = s % g.XB == 0 ? carry_state(a, q) : map_at(ex, 0);
    sc.segs[2 * s + 1] = in;
    ex = map_then(ex, segment_elem(a, g, s, m));
    if (carry_out != nullptr && s % g.XB == g.XB - 1) {
      carry_out[q] = carry_code(a, q, map_at(m, in));
    }
  }
  __syncthreads();  // the entering states, read below by other threads
  // each thread a run of blocks, their segments followed by counting
  // (block b is chunk b % XB of pattern b / (G * XB))
  const int64_t B = g.blocks();
  const int64_t bper = (B + kScanThreads - 1) / kScanThreads;
  const int64_t b0 = min64(static_cast<int64_t>(threadIdx.x) * bper, B);
  const int64_t b1 = min64(b0 + bper, B);
  const int64_t per_q = static_cast<int64_t>(g.G) * g.XB;
  const int64_t q0 = b0 / per_q;
  const int64_t r0 = b0 - q0 * per_q;
  int64_t sum = 0;
  {
    int64_t q = q0, r = r0;
    for (int64_t b = b0; b < b1; ++b) {
      sum += lane_count(sc.counts[b], sc.segs[2 * (q * g.XB + r % g.XB) + 1]);
      if (++r == per_q) r = 0, ++q;
    }
  }
  int64_t total;
  int64_t off = block_exclusive(sum, int64_t{0}, AddOp(), &total);
  {
    int64_t q = q0, r = r0;
    for (int64_t b = b0; b < b1; ++b) {
      sc.offsets[b] = off;
      off += lane_count(sc.counts[b], sc.segs[2 * (q * g.XB + r % g.XB) + 1]);
      if (++r == per_q) r = 0, ++q;
    }
  }
  if (threadIdx.x == 0) *sc.total = total;
}

// Launch 3: the candidates of the blocks that have some.
__global__ void __launch_bounds__(kSelThreads)
    emit_words(const WordArgs a, const Grid g, WordScratch sc, int64_t* out,
               int64_t N) {
  __shared__ uint8_t rel[kBlockElems];
  const Part p = part_of(g, blockIdx.x);
  const int in = sc.segs[2 * p.seg + 1];
  if (lane_count(sc.counts[blockIdx.x], in) == 0) return;  // the whole block
  bool need;
  const uint32_t mask = screened(a, p, &need);
  if (__syncthreads_or(need)) segment_chain(a, p, rel);
  int64_t o = sc.offsets[blockIdx.x];
  const int rounds = (p.elems() + kSelThreads - 1) / kSelThreads;
  for (int i = 0; i < rounds; ++i) {
    int n = 0;
    int64_t f = 0;
    bool up = false;
    if ((mask >> i) & 1u) {
      const int e = threadIdx.x + i * kSelThreads;
      f = p.base + e;
      up = needs_state(a, f) && map_at(rel[elem_tile(p, e)], in) != 0;
      n = word_candidates<false>(a, f, up, nullptr, 0, 0);
    }
    int total;
    const int before = block_exclusive(n, 0, AddOp(), &total);
    if (n > 0) word_candidates<true>(a, f, up, out, N, o + before);
    o += total;
  }
}

}  // namespace

// int64 words of scratch a call over (Q, NW, T) needs; the total (what
// sizes the output) is the last.
extern "C" long long sassy_select_words_scratch(int Q, int NW, int T) {
  return word_scratch_words(grid_of(Q, NW, T));
}

// Pass 0 counts, pass 1 scans (the carry out, and the total: the last
// word of `scratch`), pass 2 writes `out` ((4, N); nothing when N = 0).
// final, is_start, state0, carry and carry_out may be null (see
// select_words.cuh). Launches one kernel on `stream` without
// synchronising; returns the cudaError_t of the launch.
extern "C" int sassy_select_words(
    const void* vp, const void* vm, const void* cost, const void* meta,
    const void* valid_from, const void* valid_to, const void* islast,
    const void* pos_base, const void* text_end, const void* final,
    const void* is_start, const void* state0, const void* carry,
    void* carry_out, void* scratch, void* out, long long N, int Q, int NW,
    int T, int k, int all_minima, int n_prev, float alpha, int pass,
    void* stream) {
  const WordArgs a = word_args(vp, vm, cost, meta, valid_from, valid_to,
                               islast, pos_base, text_end, final, is_start,
                               state0, carry, Q, NW, T, k, all_minima,
                               n_prev, alpha);
  if (Q <= 0 || NW <= 0 || T <= 0 || n_prev < 0 || scratch == nullptr ||
      pass < 0 || pass > 2 || (pass == 2 && N > 0 && out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Grid g = grid_of(Q, NW, T);
  if (g.blocks() > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const WordScratch sc = word_scratch_at(scratch, g);
  const unsigned blocks = static_cast<unsigned>(g.blocks());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pass == 0) {
    count_words<<<blocks, kSelThreads, 0, s>>>(a, g, sc);
  } else if (pass == 1) {
    scan_words<<<1, kScanThreads, 0, s>>>(a, g, sc,
                                           static_cast<int32_t*>(carry_out));
  } else {
    emit_words<<<blocks, kSelThreads, 0, s>>>(a, g, sc,
                                              static_cast<int64_t*>(out), N);
  }
  return static_cast<int>(cudaGetLastError());
}
