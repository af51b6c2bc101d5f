// Position-level candidate selection, for Hopper (sm_90a).
//
// Replaces the XLA selections that the JAX pipeline runs after its q1 / q2
// scan kernels when an overhang search's overshoot spans more than a few
// words: minima.select_candidates (sassy_tpu/ops/minima.py:43; the single
// engine, and the sharded search's slots with their owned range and
// incoming state) and minima.select_candidates_tiles (:1019; the batched
// engine's pieces, with the state chained across them). It computes what
// the port's plain versions compute (minima.select_candidates_plain;
// select_candidates_tiles_plain, and select_candidates_chained_plain for
// the chain): from vp, vm and cost ((NW, T) or (Q, NW, T) words of uint32
// bits, the cost at each word's start), the end positions that are
// rightmost local minima of cost <= k (or, with all_minima, every such
// position), costs past the text end adding floor(float32(alpha) *
// float32(overshoot)) and the decreasing state taking those steps too.
// The walk itself, its tile records and their composition are in
// select_walk.cuh.
//
// - select_candidates: tile 0 owns window words [0, W), tile t >= 1 words
//   [halo, halo + W): the flat positions 1 .. T * W * 32 of one text;
//   position 0 costs boundary_m. The state enters tile 0 from `seed` and
//   runs through every tile (a tile's leaving state is its last nonzero
//   delta at or past the gate, overshoot steps included).
// - select_candidates_tiles: item q * T + t is pattern q's piece t. A piece
//   that resets (is_start, or every piece without it) enters with state0
//   (0 without it); pattern q's piece 0 otherwise enters with `carry`; any
//   other piece with the state its predecessor leaves, which is the last
//   raw delta in (valid_from, valid_to] (minima.last_delta_codes) or, if
//   none, the state it entered with. carry_out[q] codes the state leaving
//   pattern q's last piece (3 up, else 0; with all_minima the carry in).
//
// What bounds it on the H100: bytes, the 8 bytes of vp and vm of every
// walked word (~0.27 GB at 1 GiB), read once, and one cost a tile.
//
// What the design does about it: three launches, no PyTorch op between
// them, one host read of the 8-byte total.
// 1. walk: one thread per item walks its words once (kAhead words' loads
//    issued before it steps through them; tiles are adjacent, so a warp
//    reads 32 adjacent words of each row), for both entering states at
//    once, and writes its 16-byte TileRec; each block composes its
//    records in order into one Agg.
// 2. scan: one block composes the block aggregates in order (each thread
//    a run of them, then a block scan), giving each block its entering
//    state and output offset, and the total.
// 3. emit: each block scans its records again from its entering state and
//    offset; a thread with candidates walks only its flagged word groups
//    and writes them at its offset, in the plain version's order, with no
//    atomics. Pattern q's last piece writes carry_out[q].
// The wrapper (ops/myers_cuda.py) reads the total after launch 2 to size
// the output. Built with the scan kernels in one nvcc call.

#include "select_walk.cuh"

namespace {

constexpr int kScanThreads = 1024;
// A tile walks fewer words: its local positions stay below 2^30 (local32).
constexpr int kMaxWords = 1 << 25;

SASSY_HD int64_t cdiv64(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Scratch of `items` items (int64 words): the TileRecs, then per block of
// kSelThreads items its Agg (3 words), entering state and offset, then
// the total.
struct Scratch {
  TileRec* recs;
  Agg* aggs;
  int64_t* bstate;
  int64_t* boff;
  int64_t* total;
};

int64_t scratch_words(int64_t items) {
  const int64_t nb = cdiv64(items, kSelThreads);
  return 2 * items + 5 * nb + 1;
}

Scratch scratch_at(void* p, int64_t items) {
  const int64_t nb = cdiv64(items, kSelThreads);
  int64_t* w = static_cast<int64_t*>(p);
  Scratch s;
  s.recs = reinterpret_cast<TileRec*>(w);
  s.aggs = reinterpret_cast<Agg*>(w + 2 * items);
  s.bstate = w + 2 * items + 3 * nb;
  s.boff = s.bstate + nb;
  s.total = s.boff + nb;
  return s;
}

__device__ Agg shfl_up_agg(const Agg& a, int d) {
  Agg b;
  b.n[0] = __shfl_up_sync(0xFFFFFFFFu, a.n[0], d);
  b.n[1] = __shfl_up_sync(0xFFFFFFFFu, a.n[1], d);
  b.map = __shfl_up_sync(0xFFFFFFFFu, a.map, d);
  return b;
}

// The composition of the block's earlier threads' values, in thread
// order (the identity for thread 0); `all` gets the whole block's. smem:
// one Agg per warp. Every thread of the block calls it.
__device__ Agg block_exclusive(Agg mine, Agg* smem, Agg* all) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  Agg inc = mine;
  for (int d = 1; d < 32; d <<= 1) {
    const Agg o = shfl_up_agg(inc, d);
    if (lane >= d) inc = compose(o, inc);
  }
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Agg w = lane < warps ? smem[lane] : agg_identity();
    for (int d = 1; d < 32; d <<= 1) {
      const Agg o = shfl_up_agg(w, d);
      if (lane >= d) w = compose(o, w);
    }
    if (lane < warps) smem[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  Agg ex = shfl_up_agg(inc, 1);
  if (lane == 0) ex = agg_identity();
  if (warp > 0) ex = compose(smem[warp - 1], ex);
  *all = smem[warps - 1];
  return ex;
}

// Launch 1: every item's record, and each block's composition of them.
template <class Args>
__global__ void __launch_bounds__(kSelThreads)
    walk_items(const Args a, int64_t items, Scratch sc) {
  __shared__ Agg smem[kSelThreads / 32];
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kSelThreads + threadIdx.x;
  Agg mine = agg_identity();
  if (item < items) {
    const TileRec r = record_of(a, item);
    sc.recs[item] = r;
    mine = agg_of(r);
  }
  Agg all;
  block_exclusive(mine, smem, &all);
  if (threadIdx.x == 0) sc.aggs[blockIdx.x] = all;
}

// Launch 2, one block: each block's entering state and offset, from state
// 0 before item 0 (whose state is forced or unused), and the total.
__global__ void __launch_bounds__(kScanThreads)
    scan_blocks(int64_t nb, Scratch sc) {
  __shared__ Agg smem[kScanThreads / 32];
  const int64_t per = cdiv64(nb, kScanThreads);
  const int64_t b0 = threadIdx.x * per;
  const int64_t b1 = b0 + per < nb ? b0 + per : nb;
  Agg mine = agg_identity();
  for (int64_t b = b0; b < b1; ++b) mine = compose(mine, sc.aggs[b]);
  Agg all;
  const Agg pre = block_exclusive(mine, smem, &all);
  int s = leave(pre.map, 0);
  int64_t off = pre.n[0];
  for (int64_t b = b0; b < b1; ++b) {
    const Agg g = sc.aggs[b];
    sc.bstate[b] = s;
    sc.boff[b] = off;
    off += g.n[s];
    s = leave(g.map, s);
  }
  if (threadIdx.x == 0) *sc.total = all.n[0];
}

// Launch 3: each item's entering state and offset; the candidates of the
// items that have some; each pattern's carry out (carry_out, pieces).
template <class Args>
__global__ void __launch_bounds__(kSelThreads)
    emit_items(const Args a, int64_t items, Scratch sc, int32_t* carry_out,
               int64_t* out, int64_t N) {
  __shared__ Agg smem[kSelThreads / 32];
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kSelThreads + threadIdx.x;
  TileRec r;
  r.n[0] = r.n[1] = 0;
  r.bits = 2ull << kMapShift;
  if (item < items) r = sc.recs[item];
  Agg all;
  const Agg pre = block_exclusive(agg_of(r), smem, &all);
  const int sb = static_cast<int>(sc.bstate[blockIdx.x]);
  const int s = leave(pre.map, sb);
  if (item >= items) return;
  if (carry_out != nullptr && item % a.T == a.T - 1) {
    const int64_t q = item / a.T;
    carry_out[q] = carry_code(a, q, leave(agg_of(r).map, s));
  }
  if (out != nullptr && r.n[s] != 0) {
    emit_item(a, item, r, s, out, N, sc.boff[blockIdx.x] + pre.n[sb]);
  }
}

// Launch 1, 2 or 3 (pass 0, 1, 2) over `items` items.
template <class Args>
int launch_pass(const Args& a, int64_t items, void* scratch, int pass,
                int32_t* carry_out, int64_t* out, int64_t N, cudaStream_t s) {
  const int64_t nb = cdiv64(items, kSelThreads);
  const Scratch sc = scratch_at(scratch, items);
  if (pass == 0) {
    walk_items<Args><<<static_cast<unsigned>(nb), kSelThreads, 0, s>>>(a, items, sc);
  } else if (pass == 1) {
    scan_blocks<<<1, kScanThreads, 0, s>>>(nb, sc);
  } else {
    emit_items<Args><<<static_cast<unsigned>(nb), kSelThreads, 0, s>>>(
        a, items, sc, carry_out, N > 0 ? out : nullptr, N);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_items(int64_t items) {
  return items <= 0 || cdiv64(items, kSelThreads) > 0x7FFFFFFFLL;
}

}  // namespace

// int64 words of scratch a call over `items` items needs; the total
// (what sizes the output) is the last.
extern "C" long long sassy_select_scratch_words(long long items) {
  return scratch_words(items);
}

// select_candidates over the tiles of one text: pass 0 walks (the
// records), 1 scans (the total, last word of `scratch`), 2 writes `out`
// ((2, N) [position; cost]; nothing when N = 0). min_pos 0 and owned_end
// past max_pos when the caller has none; gated: deltas below min_pos do
// not feed the state; seed: the state entering tile 0 (1 up). Launches
// one kernel on `stream` without synchronising; returns the cudaError_t
// of the launch.
extern "C" int sassy_select_positions(
    const void* vp, const void* vm, const void* cost, void* scratch,
    void* out, long long sw, long long boundary_m, long long n_text,
    long long max_pos, long long min_pos, long long owned_end, long long N,
    int T, int W, int halo, int k, int all_minima, int gated, int seed,
    float alpha, int pass, void* stream) {
  const TextArgs a = text_args(vp, vm, cost, sw, boundary_m, n_text, max_pos,
                               min_pos, owned_end, T, W, halo, k, all_minima,
                               gated, seed, alpha);
  if (bad_items(T) || W <= 0 || W >= kMaxWords || halo < 0 ||
      scratch == nullptr || pass < 0 ||
      pass > 2 || (pass == 2 && N > 0 && out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_pass(a, T, scratch, pass, nullptr, static_cast<int64_t*>(out),
                     N, static_cast<cudaStream_t>(stream));
}

// select_candidates_tiles over Q patterns' pieces: the passes of
// sassy_select_positions; pass 2 writes `out` ((4, N) [pattern; piece;
// pos_base + position; cost]) and `carry_out` ((Q,), may be null).
// state0 (Q, T), is_start (T,) and carry (Q,) may be null (see the
// header). Returns the cudaError_t of the launch.
extern "C" int sassy_select_positions_tiles(
    const void* vp, const void* vm, const void* cost, const void* boundary0,
    const void* text_end, const void* valid_from, const void* valid_to,
    const void* islast, const void* pos_base, const void* state0,
    const void* is_start, const void* carry, void* carry_out, void* scratch,
    void* out, long long sq, long long sw, long long N, int Q, int NW, int T,
    int k, int all_minima, float alpha, int pass, void* stream) {
  const PieceArgs a = piece_args(vp, vm, cost, boundary0, text_end, valid_from,
                                 valid_to, islast, pos_base, state0, is_start,
                                 carry, sq, sw, Q, NW, T, k, all_minima, alpha);
  const int64_t items = static_cast<int64_t>(Q) * T;
  if (Q <= 0 || T <= 0 || bad_items(items) || NW <= 0 || NW >= kMaxWords ||
      scratch == nullptr ||
      pass < 0 || pass > 2 || (pass == 2 && N > 0 && out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_pass(a, items, scratch, pass, static_cast<int32_t*>(carry_out),
                     static_cast<int64_t*>(out), N,
                     static_cast<cudaStream_t>(stream));
}
