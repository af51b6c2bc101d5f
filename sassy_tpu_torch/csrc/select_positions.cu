// Position-level candidate selection, for Hopper (sm_90a).
//
// Replaces the XLA selections that the JAX pipeline runs after its q1 / q2
// scan kernels when an overhang search's overshoot spans more than a few
// words: minima.select_candidates (sassy_tpu/ops/minima.py:43; the single
// engine, and the sharded search's slots with their owned range and
// incoming state) and minima.select_candidates_tiles (:1019; the batched
// engine's pieces). It computes what the port's plain versions,
// minima.select_candidates_plain and select_candidates_tiles_plain,
// compute: from vp, vm and cost ((NW, T) or (Q, NW, T) words of uint32
// bits, the cost at each word's start), the end positions that are
// rightmost local minima of cost <= k (or, with all_minima, every such
// position), costs past the text end adding floor(float32(alpha) *
// float32(overshoot)) and the decreasing state taking those steps too.
//
// - select_candidates: tile 0 owns window words [0, W), tile t >= 1 words
//   [halo, halo + W): the flat positions 1 .. T * W * 32 of one text;
//   position 0 costs boundary_m. Positions past max_pos, below min_pos or
//   past owned_end are not reported; max_pos needs no lookahead; with an
//   incoming state, deltas below min_pos do not feed the state. The state
//   entering a tile is the last nonzero delta before it: a first pass
//   writes each tile's last code, PyTorch chains them
//   (minima.tile_state_chain_codes, a cummax over the tiles), and the
//   counting and writing passes start each tile from its chained state.
//   The lookahead of a tile's last position is the next tile's first delta
//   (+1 past the last tile). Output (2, N): [end position; cost].
// - select_candidates_tiles: piece (q, t) walks its window positions
//   0 .. NW * 32; position 0 costs boundary0; reported positions lie in
//   (valid_from, valid_to]; deltas at or below valid_from (the halo) do not
//   feed the state, which starts from state0; islast needs no lookahead,
//   and the delta past the window is +1. Output (4, N): [pattern; piece;
//   pos_base + position; cost].
//
// What bounds it on the H100: bytes, the 12 bytes of vp, vm and cost of
// every walked word (~0.4 GB at 1 GiB), read once by the counting pass.
//
// What the design does about it: one thread per (pattern, tile) walks its
// positions in order and carries the cost, the decreasing state and the
// pending candidate (which waits for the next position's delta) in
// registers; nothing is materialised per position. Tiles are adjacent in
// memory, so a warp reads 32 adjacent words of each row. A word whose
// lowest possible cost (its start cost less popc(vm)) exceeds k and which
// lies before the text end is skipped whole: only its first delta (for the
// pending candidate) and its last owned delta (__clz of the masked words,
// for the state) are taken. The tile codes walk backwards from the tile's
// end and stop at the first nonzero delta. The counting pass writes one
// count per thread; PyTorch's cumsum and one host read of the total size
// the output; the writing pass skips threads without a candidate. The
// output is in the plain version's order. Built by
// sassy_tpu_torch/ops/myers_cuda.py with the scan kernels in one nvcc call.

#include "select_common.cuh"

namespace {

// Whether the highest set bit of vp lies above that of vm (-1 for zero):
// the sign of the last nonzero delta of a word whose bits are vp (+1) and
// vm (-1), given vp | vm != 0 (minima._last_delta_up).
__device__ __forceinline__ bool last_delta_up(uint32_t vp, uint32_t vm) {
  return (31 - __clz(vp)) > (31 - __clz(vm));
}

// Bits b >= s of a word (s clamped to [0, 32]).
__device__ __forceinline__ uint32_t bits_from(int64_t s) {
  if (s <= 0) return 0xFFFFFFFFu;
  if (s >= 32) return 0u;
  return 0xFFFFFFFFu << static_cast<int>(s);
}

// One thread's walk over local positions 0 .. nw * 32 of one tile.
struct Walk {
  const uint32_t* vp;  // word 0 of the walk; words are sw apart
  const uint32_t* vm;
  const int32_t* cost;
  int64_t sw;
  int nw;
  bool has0;        // local position 0 is walked, at cost c0
  int64_t c0;
  int64_t lo, hi;   // reported local positions [lo, hi]
  int64_t gate;     // local positions below it do not feed the state
  int64_t last;     // the local position whose lookahead always passes
  int64_t tend;     // local text end: overshoot = position - tend
  int64_t next;     // the delta after local position nw * 32
  bool up;          // the state entering: the last delta was +1
};

// Where a walk writes: (4, N) [q; t; base + position; cost] with qt, else
// (2, N) [base + position; cost].
struct Sink {
  int64_t* out;
  int64_t N;
  int64_t at;
  int64_t base;
  int q, t;
  bool qt;
};

template <bool EMIT>
__device__ int walk(const Walk& w, int k, bool all_minima, float alpha,
                    const Sink& s) {
  const bool over = alpha != 0.0f;
  const int64_t tend = w.tend;
  auto ov = [over, alpha, tend](int64_t lp) -> int64_t {
    return over ? overshoot_floor(alpha, lp - tend) : 0;
  };
  int n = 0;
  auto take = [&](int64_t lp, int64_t c) {
    if (EMIT) {
      const int64_t i = s.at + n;
      if (s.qt) {
        s.out[i] = s.q;
        s.out[s.N + i] = s.t;
        s.out[2 * s.N + i] = s.base + lp;
        s.out[3 * s.N + i] = c;
      } else {
        s.out[i] = s.base + lp;
        s.out[s.N + i] = c;
      }
    }
    ++n;
  };

  bool up = w.up;
  bool pend = false;  // a candidate at pend_lp, waiting for the next delta
  int64_t pend_lp = 0;
  int64_t pend_cost = 0;
  int64_t ov_prev = ov(0);
  if (w.has0) {
    pend_cost = w.c0 + ov_prev;
    pend = w.lo <= 0 && w.hi >= 0 && pend_cost <= k && (all_minima || !up);
  }
  for (int i = 0; i < w.nw; ++i) {
    const uint32_t vp = w.vp[i * w.sw];
    const uint32_t vm = w.vm[i * w.sw];
    const int64_t cw = w.cost[i * w.sw];
    const int64_t l0 = static_cast<int64_t>(i) * 32;
    if ((!over || l0 + 32 <= tend) && cw - __popc(vm) > k) {
      // no position of the word costs <= k, none lies past the text end
      if (pend && (all_minima || bit_delta(vp, vm, 0) >= 1 || pend_lp == w.last)) {
        take(pend_lp, pend_cost);
      }
      pend = false;
      if (!all_minima) {
        const uint32_t g = bits_from(w.gate - l0 - 1);
        if (((vp | vm) & g) != 0) up = last_delta_up(vp & g, vm & g);
      }
      ov_prev = 0;
      continue;
    }
    int64_t raw_cost = cw;
    for (int b = 0; b < 32; ++b) {
      const int64_t lp = l0 + b + 1;
      const int raw = bit_delta(vp, vm, b);
      const int64_t ov_l = ov(lp);
      const int64_t d = raw + ov_l - ov_prev;
      if (pend && (all_minima || d >= 1 || pend_lp == w.last)) {
        take(pend_lp, pend_cost);
      }
      raw_cost += raw;
      const int64_t c = raw_cost + ov_l;
      if (!all_minima && lp >= w.gate && d != 0) up = d > 0;
      pend = lp >= w.lo && lp <= w.hi && c <= k && (all_minima || !up);
      pend_lp = lp;
      pend_cost = c;
      ov_prev = ov_l;
    }
  }
  if (pend && (all_minima || w.next >= 1 || pend_lp == w.last)) {
    take(pend_lp, pend_cost);
  }
  return n;
}

// The code of the walk's last nonzero delta at a position >= gate: 0 none,
// 2 for -1, 3 for +1 (minima.last_delta_codes' coding).
__device__ int last_code(const Walk& w, float alpha) {
  const bool over = alpha != 0.0f;
  for (int i = w.nw - 1; i >= 0; --i) {
    const int64_t l0 = static_cast<int64_t>(i) * 32;
    if (l0 + 32 < w.gate) break;
    const uint32_t vp = w.vp[i * w.sw];
    const uint32_t vm = w.vm[i * w.sw];
    if (!over || l0 + 32 <= w.tend) {
      const uint32_t g = bits_from(w.gate - l0 - 1);
      if (((vp | vm) & g) != 0) return 2 + last_delta_up(vp & g, vm & g);
      continue;
    }
    for (int b = 31; b >= 0; --b) {
      const int64_t lp = l0 + b + 1;
      if (lp < w.gate) break;
      const int64_t d = bit_delta(vp, vm, b) +
                        overshoot_floor(alpha, lp - w.tend) -
                        overshoot_floor(alpha, lp - 1 - w.tend);
      if (d != 0) return d > 0 ? 3 : 2;
    }
  }
  return 0;
}

struct TextArgs {  // select_candidates: the tiles of one text
  const uint32_t* vp;
  const uint32_t* vm;
  const int32_t* cost;
  int64_t sw;
  int T, W, halo, k;
  bool all_minima, gated;
  float alpha;
  int64_t boundary_m, n_text, max_pos, min_pos, owned_end;
  const int32_t* chain;  // (T,) the state entering each tile, 1 = up
  int32_t* codes;        // (T,) pass 0
  int32_t* counts;       // (T,) pass 1
  const int64_t* ends;   // (T,) their inclusive prefix sums
  int64_t* out;
  int64_t N;
};

__device__ Walk text_walk(const TextArgs& a, int t) {
  const int64_t span = static_cast<int64_t>(a.W) * 32;
  const int64_t base = t * span;
  const int64_t col = (t == 0 ? 0 : static_cast<int64_t>(a.halo) * a.sw) + t;
  Walk w;
  w.vp = a.vp + col;
  w.vm = a.vm + col;
  w.cost = a.cost + col;
  w.sw = a.sw;
  w.nw = a.W;
  w.has0 = t == 0;
  w.c0 = a.boundary_m;
  w.lo = a.min_pos - base;
  w.hi = (a.owned_end < a.max_pos ? a.owned_end : a.max_pos) - base;
  w.gate = a.gated ? a.min_pos - base : 0;
  w.last = a.max_pos - base;
  w.tend = a.n_text - base;
  w.next = 1;
  if (t + 1 < a.T) {
    const int64_t nc = static_cast<int64_t>(a.halo) * a.sw + t + 1;
    w.next = bit_delta(a.vp[nc], a.vm[nc], 0);
    if (a.alpha != 0.0f) {
      w.next += overshoot_floor(a.alpha, span + 1 - w.tend) -
                overshoot_floor(a.alpha, span - w.tend);
    }
  }
  w.up = !a.all_minima && a.chain != nullptr && a.chain[t] != 0;
  return w;
}


__global__ void __launch_bounds__(kSelThreads) text_codes(const TextArgs a) {
  const int t = blockIdx.x * kSelThreads + threadIdx.x;
  if (t >= a.T) return;
  a.codes[t] = last_code(text_walk(a, t), a.alpha);
}

__global__ void __launch_bounds__(kSelThreads) text_select(const TextArgs a,
                                                           bool emit) {
  const int t = blockIdx.x * kSelThreads + threadIdx.x;
  if (t >= a.T) return;
  Sink s = {a.out, a.N, 0, static_cast<int64_t>(t) * a.W * 32, 0, t, false};
  if (!emit) {
    a.counts[t] = walk<false>(text_walk(a, t), a.k, a.all_minima, a.alpha, s);
    return;
  }
  const int n = a.counts[t];
  if (n == 0) return;
  s.at = a.ends[t] - n;
  walk<true>(text_walk(a, t), a.k, a.all_minima, a.alpha, s);
}

struct PieceArgs {  // select_candidates_tiles: Q patterns over T pieces
  const uint32_t* vp;
  const uint32_t* vm;
  const int32_t* cost;
  int64_t sq, sw;
  const int32_t* boundary0;  // (Q, T)
  const int64_t* text_end;   // (T,)
  const int32_t* valid_from;
  const int32_t* valid_to;
  const int32_t* islast;
  const int64_t* pos_base;
  const int32_t* state0;     // (Q, T)
  int Q, NW, T, k;
  bool all_minima;
  float alpha;
  int32_t* counts;           // (Q * T,) pass 1
  const int64_t* ends;       // their inclusive prefix sums
  int64_t* out;
  int64_t N;
};

__global__ void __launch_bounds__(kSelThreads) piece_select(const PieceArgs a,
                                                            bool emit) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kSelThreads + threadIdx.x;
  if (g >= static_cast<int64_t>(a.Q) * a.T) return;
  const int q = static_cast<int>(g / a.T);
  const int t = static_cast<int>(g - static_cast<int64_t>(q) * a.T);
  const int n_emit = emit ? a.counts[g] : 0;
  if (emit && n_emit == 0) return;
  const int64_t col = q * a.sq + t;
  const int64_t vf = a.valid_from[t];
  Walk w;
  w.vp = a.vp + col;
  w.vm = a.vm + col;
  w.cost = a.cost + col;
  w.sw = a.sw;
  w.nw = a.NW;
  w.has0 = true;
  w.c0 = a.boundary0[g];
  w.lo = vf + 1;
  w.hi = a.valid_to[t];
  w.gate = vf + 1;
  w.last = a.islast[t];
  w.tend = a.text_end[t];
  w.next = 1;
  w.up = !a.all_minima && a.state0[g] > 0;
  Sink s = {a.out, a.N, 0, a.pos_base[t], q, t, true};
  if (!emit) {
    a.counts[g] = walk<false>(w, a.k, a.all_minima, a.alpha, s);
    return;
  }
  s.at = a.ends[g] - n_emit;
  walk<true>(w, a.k, a.all_minima, a.alpha, s);
}

unsigned blocks_of(long long threads) {
  return static_cast<unsigned>((threads + kSelThreads - 1) / kSelThreads);
}

}  // namespace

// select_candidates over the tiles of one text. pass 0 writes each tile's
// last code (`codes`), pass 1 each tile's candidate count (`counts`, from
// the chained states `chain`; null with all_minima), pass 2 the candidates
// (`out`, (2, N), at the inclusive prefix sums `ends` of the counts).
// min_pos 0 and owned_end past max_pos when the caller has none; gated:
// deltas below min_pos do not feed the state. Launches on `stream` without
// synchronising; returns the cudaError_t of the launch.
extern "C" int sassy_select_positions(
    const void* vp, const void* vm, const void* cost, const void* chain,
    void* codes, void* counts, const void* ends, void* out, long long sw,
    long long boundary_m, long long n_text, long long max_pos,
    long long min_pos, long long owned_end, long long N, int T, int W,
    int halo, int k, int all_minima, int gated, float alpha, int pass,
    void* stream) {
  TextArgs a = {};
  a.vp = static_cast<const uint32_t*>(vp);
  a.vm = static_cast<const uint32_t*>(vm);
  a.cost = static_cast<const int32_t*>(cost);
  a.sw = sw;
  a.T = T;
  a.W = W;
  a.halo = halo;
  a.k = k;
  a.all_minima = all_minima != 0;
  a.gated = gated != 0;
  a.alpha = alpha;
  a.boundary_m = boundary_m;
  a.n_text = n_text;
  a.max_pos = max_pos;
  a.min_pos = min_pos;
  a.owned_end = owned_end;
  a.chain = static_cast<const int32_t*>(chain);
  a.codes = static_cast<int32_t*>(codes);
  a.counts = static_cast<int32_t*>(counts);
  a.ends = static_cast<const int64_t*>(ends);
  a.out = static_cast<int64_t*>(out);
  a.N = N;
  if (T <= 0 || W <= 0 || halo < 0 ||
      (pass == 0 && codes == nullptr) ||
      (pass >= 1 && (counts == nullptr ||
                     (!a.all_minima && chain == nullptr))) ||
      (pass == 2 && (ends == nullptr || out == nullptr)) || pass < 0 ||
      pass > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pass == 0) {
    text_codes<<<blocks_of(T), kSelThreads, 0, s>>>(a);
  } else {
    text_select<<<blocks_of(T), kSelThreads, 0, s>>>(a, pass == 2);
  }
  return static_cast<int>(cudaGetLastError());
}

// select_candidates_tiles. pass 1 writes each (pattern, piece)'s candidate
// count (`counts`), pass 2 the candidates (`out`, (4, N), at the inclusive
// prefix sums `ends` of the counts). Launches on `stream` without
// synchronising; returns the cudaError_t of the launch.
extern "C" int sassy_select_positions_tiles(
    const void* vp, const void* vm, const void* cost, const void* boundary0,
    const void* text_end, const void* valid_from, const void* valid_to,
    const void* islast, const void* pos_base, const void* state0,
    void* counts, const void* ends, void* out, long long sq, long long sw,
    long long N, int Q, int NW, int T, int k, int all_minima, float alpha,
    int pass, void* stream) {
  PieceArgs a = {};
  a.vp = static_cast<const uint32_t*>(vp);
  a.vm = static_cast<const uint32_t*>(vm);
  a.cost = static_cast<const int32_t*>(cost);
  a.sq = sq;
  a.sw = sw;
  a.boundary0 = static_cast<const int32_t*>(boundary0);
  a.text_end = static_cast<const int64_t*>(text_end);
  a.valid_from = static_cast<const int32_t*>(valid_from);
  a.valid_to = static_cast<const int32_t*>(valid_to);
  a.islast = static_cast<const int32_t*>(islast);
  a.pos_base = static_cast<const int64_t*>(pos_base);
  a.state0 = static_cast<const int32_t*>(state0);
  a.Q = Q;
  a.NW = NW;
  a.T = T;
  a.k = k;
  a.all_minima = all_minima != 0;
  a.alpha = alpha;
  a.counts = static_cast<int32_t*>(counts);
  a.ends = static_cast<const int64_t*>(ends);
  a.out = static_cast<int64_t*>(out);
  a.N = N;
  const long long threads = static_cast<long long>(Q) * T;
  if (threads <= 0 || NW <= 0 ||
      (threads + kSelThreads - 1) / kSelThreads > 0x7FFFFFFFLL ||
      counts == nullptr || (pass == 2 && (ends == nullptr || out == nullptr)) ||
      pass < 1 || pass > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  piece_select<<<blocks_of(threads), kSelThreads, 0, s>>>(a, pass == 2);
  return static_cast<int>(cudaGetLastError());
}
