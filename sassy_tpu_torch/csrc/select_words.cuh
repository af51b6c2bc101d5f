// The word-level candidate selection (select_words.cu): its grid, the
// candidates of one (pattern, word, tile) element, and the state chain
// across tiles, as __host__ __device__ functions. The kernels run them on
// the card; a host build of this header (tests/torch_select_words_host.cc)
// runs them in the kernels' order and holds the result to the plain
// versions, minima.select_words_tiles_q_plain and
// select_words_chained_plain, without one.
//
// The grid: block b covers the rows (q, w), w in [g * R, (g + 1) * R), of
// tiles [x * TC, (x + 1) * TC), with b = (q * G + g) * XB + x: at most
// kBlockElems elements, in the plain version's (pattern, word, tile)
// order. A row of more than kBlockElems tiles is cut into XB chunks (one
// row a block); a shorter row is one chunk, and R rows share a block. The
// tiles of one pattern in one chunk are a segment, the chain's unit.
//
// The chain: the state entering a tile (whether the last owned delta
// before it was +1) is fixed where the tile resets (every tile without
// is_start, with state0; a tile of is_start enters not up), is the carry
// at pattern q's first tile, and else is the state the tile before
// leaves: its last owned delta's (final: 2 down, 3 up) or, without one,
// the state it entered with. Each tile is a map of two states, and a run
// of tiles the composition of their maps, so a segment's tiles compose in
// any grouping (chain_run), and the segments in order (the kernels' one
// block scan) give every segment its entering state.

#pragma once

#include "select_common.cuh"

namespace {

constexpr int kWordsPerThread = 32;
constexpr int kBlockElems = kSelThreads * kWordsPerThread;

struct WordArgs {  // (Q, NW, T) arrays, contiguous
  const uint32_t* vp;
  const uint32_t* vm;
  const int32_t* cost;
  const int32_t* meta;
  const int32_t* valid_from;  // (T,) window-local owned range (vf, vt]
  const int32_t* valid_to;
  const int32_t* islast;    // (T,) window-local last text position, or -1
  const int64_t* pos_base;  // (T,) position of window position 0
  const int64_t* text_end;  // (T,) window-local text end; null: no overhang
  const int32_t* final;     // (Q, T) each tile's last owned delta; null: none
  const uint8_t* is_start;  // (T,) the tiles that reset; null: every tile
  const int32_t* state0;    // (Q, T) the state of a tile that resets; null: 0
  const int32_t* carry;     // (Q,) the code entering tile 0 (3 up); null: 0
  float alpha;
  int n_prev;
  int Q, NW, T, k;
  bool all_minima;
};

// ---- the two states' maps -------------------------------------------------

// A map of the state (0 not up, 1 up): bit s is the state after when s is
// the state before.
constexpr uint32_t kIdentity = 2u;

SASSY_HD int map_at(uint32_t map, int s) {
  return static_cast<int>((map >> s) & 1u);
}

SASSY_HD uint32_t map_const(int s) { return s ? 3u : 0u; }

// The map a, then the map b.
SASSY_HD uint32_t map_then(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>(map_at(b, map_at(a, 0))) |
         (static_cast<uint32_t>(map_at(b, map_at(a, 1))) << 1);
}

// ---- the grid -------------------------------------------------------------

struct Grid {
  int Q, NW, T;
  int XB;  // tile chunks a row
  int TC;  // tiles a chunk (the last may have fewer)
  int R;   // rows a block
  int G;   // row groups a pattern
  SASSY_HD int64_t blocks() const { return static_cast<int64_t>(Q) * G * XB; }
  SASSY_HD int64_t segments() const { return static_cast<int64_t>(Q) * XB; }
};

SASSY_HD Grid grid_of(int Q, int NW, int T) {
  Grid g;
  g.Q = Q;
  g.NW = NW;
  g.T = T;
  g.XB = (T + kBlockElems - 1) / kBlockElems;
  g.TC = (T + g.XB - 1) / g.XB;  // XB > 1: TC > kBlockElems / 2, so R = 1
  g.R = kBlockElems / g.TC < NW ? kBlockElems / g.TC : NW;
  g.G = (NW + g.R - 1) / g.R;
  return g;
}

// Block b's rows [w0, w1) of pattern q, its tiles [t0, t1), its segment.
// Its elements are adjacent in memory from flat index `base`: a block of
// several rows covers whole rows (XB = 1, so t0 = 0 and t1 = T).
struct Part {
  int q, w0, w1, t0, t1;
  int64_t seg, base;
  SASSY_HD int width() const { return t1 - t0; }
  SASSY_HD int elems() const { return (w1 - w0) * (t1 - t0); }
};

SASSY_HD Part part_of(const Grid& g, int64_t b) {
  Part p;
  const int x = static_cast<int>(b % g.XB);
  const int64_t qg = b / g.XB;
  p.q = static_cast<int>(qg / g.G);
  const int gr = static_cast<int>(qg - static_cast<int64_t>(p.q) * g.G);
  p.w0 = gr * g.R;
  p.w1 = p.w0 + g.R < g.NW ? p.w0 + g.R : g.NW;
  p.t0 = x * g.TC;
  p.t1 = p.t0 + g.TC < g.T ? p.t0 + g.TC : g.T;
  p.seg = static_cast<int64_t>(p.q) * g.XB + x;
  p.base = (static_cast<int64_t>(p.q) * g.NW + p.w0) * g.T + p.t0;
  return p;
}

// The tile (its index within the chunk) of the block's element i.
SASSY_HD int elem_tile(const Part& p, int i) { return i % p.width(); }

// ---- the chain --------------------------------------------------------------

// Whether tile (q, t)'s entering state is fixed, and to what (*s).
SASSY_HD bool tile_reset(const WordArgs& a, int q, int t, int* s) {
  *s = 0;
  if (a.is_start != nullptr && a.is_start[t] == 0) return false;
  *s = a.state0 != nullptr && a.state0[static_cast<int64_t>(q) * a.T + t] != 0;
  return true;
}

// The tiles [t0, t1) of pattern q after `before`, the map from a
// segment's entering state to the state the tile before t0 leaves: each
// tile's entering map into rel[t - base] (when rel is not null). Returns
// the map to the state tile t1 - 1 leaves. From kIdentity it is the map
// of the run alone.
SASSY_HD uint32_t chain_run(const WordArgs& a, int q, int t0, int t1,
                            uint32_t before, uint8_t* rel, int base) {
  for (int t = t0; t < t1; ++t) {
    int s;
    const uint32_t enter = tile_reset(a, q, t, &s) ? map_const(s) : before;
    if (rel != nullptr) rel[t - base] = static_cast<uint8_t>(enter);
    const int code =
        a.final != nullptr ? a.final[static_cast<int64_t>(q) * a.T + t] : 0;
    before = code > 0 ? map_const(code & 1) : enter;
  }
  return before;
}

// The state entering pattern q's first tile.
SASSY_HD int carry_state(const WordArgs& a, int q) {
  return a.carry != nullptr && (a.carry[q] & 3) == 3;
}

// The code carried out of pattern q (3 up, else 0) when its last tile
// leaves `leaving`; with all_minima, where no state is kept, the carry in.
SASSY_HD int32_t carry_code(const WordArgs& a, int q, int leaving) {
  if (a.all_minima) return a.carry != nullptr ? a.carry[q] : 0;
  return leaving ? 3 : 0;
}

// Segment s in the scan of all segments in order: its map, and at a
// pattern's first chunk the carry composed in, so that no state passes
// from one pattern to the next.
SASSY_HD uint32_t segment_elem(const WordArgs& a, const Grid& g, int64_t s,
                               uint32_t seg_map) {
  if (s % g.XB != 0) return seg_map;
  return map_const(map_at(seg_map, carry_state(a, static_cast<int>(s / g.XB))));
}

// ---- one element --------------------------------------------------------

// Flat element f = (q * NW + w) * T + t decoded.
SASSY_HD void decode(const WordArgs& a, int64_t f, int* q, int* w, int* t) {
  const int64_t per_q = static_cast<int64_t>(a.NW) * a.T;
  *q = static_cast<int>(f / per_q);
  const int64_t r = f - *q * per_q;
  *w = static_cast<int>(r / a.T);
  *t = static_cast<int>(r - static_cast<int64_t>(*w) * a.T);
}

// The meta code at the start of element f's strip (the n_prev words
// before its word, within the tile): 0 when no owned delta came earlier.
SASSY_HD int strip_code(const WordArgs& a, int64_t f, int w) {
  const int w0 = w - (w < a.n_prev ? w : a.n_prev);
  return (a.meta[f - static_cast<int64_t>(w - w0) * a.T] >> 1) & 3;
}

// Whether element f's candidates depend on its tile's entering state: a
// screened word, the state kept, no owned delta earlier in its tile.
SASSY_HD bool needs_state(const WordArgs& a, int64_t f) {
  if (a.all_minima || (a.meta[f] & 1) == 0) return false;
  int q, w, t;
  decode(a, f, &q, &w, &t);
  return strip_code(a, f, w) == 0;
}

// The candidates of flat element f, its tile entered with state up_tile
// (read only where needs_state): their count, and with EMIT each written
// at out column o + i of the (4, N) columns.
template <bool EMIT>
SASSY_HD int word_candidates(const WordArgs& a, int64_t f, bool up_tile,
                             int64_t* out, int64_t N, int64_t o) {
  if ((a.meta[f] & 1) == 0) return 0;
  int q, w, t;
  decode(a, f, &q, &w, &t);
  const int64_t at = f;
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
    // earlier in the tile, else the tile's entering state; then the
    // strip's overshoot-adjusted deltas
    const int w0 = w - (w < a.n_prev ? w : a.n_prev);
    const int code = strip_code(a, f, w);
    up = code > 0 ? (code & 1) != 0 : up_tile;
    for (int ww = w0; ww < w; ++ww) {
      const int64_t at_w = at - static_cast<int64_t>(w - ww) * a.T;
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
      out[i] = q;
      out[N + i] = t;
      out[2 * N + i] = a.pos_base[t] + w32 + j;
      out[3 * N + i] = c;
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

// Element f's candidates when its segment enters with state `seg_in`, its
// tile's entering map (from the segment's state) at rel.
SASSY_HD int count_at(const WordArgs& a, int64_t f, uint32_t rel, int seg_in) {
  return word_candidates<false>(a, f, map_at(rel, seg_in) != 0, nullptr, 0, 0);
}

// The arguments of the C entry point (select_words.cu), as the kernels
// take them.
inline WordArgs word_args(const void* vp, const void* vm, const void* cost,
                          const void* meta, const void* valid_from,
                          const void* valid_to, const void* islast,
                          const void* pos_base, const void* text_end,
                          const void* final, const void* is_start,
                          const void* state0, const void* carry, int Q,
                          int NW, int T, int k, int all_minima, int n_prev,
                          float alpha) {
  WordArgs a = {};
  a.vp = static_cast<const uint32_t*>(vp);
  a.vm = static_cast<const uint32_t*>(vm);
  a.cost = static_cast<const int32_t*>(cost);
  a.meta = static_cast<const int32_t*>(meta);
  a.valid_from = static_cast<const int32_t*>(valid_from);
  a.valid_to = static_cast<const int32_t*>(valid_to);
  a.islast = static_cast<const int32_t*>(islast);
  a.pos_base = static_cast<const int64_t*>(pos_base);
  a.text_end = static_cast<const int64_t*>(text_end);
  a.final = static_cast<const int32_t*>(final);
  a.is_start = static_cast<const uint8_t*>(is_start);
  a.state0 = static_cast<const int32_t*>(state0);
  a.carry = static_cast<const int32_t*>(carry);
  a.alpha = alpha;
  a.n_prev = n_prev;
  a.Q = Q;
  a.NW = NW;
  a.T = T;
  a.k = k;
  a.all_minima = all_minima != 0;
  return a;
}

// Both lanes' counts in one word: n0 in the low half, n1 in the high.
SASSY_HD int64_t pack_counts(int n0, int n1) {
  return static_cast<int64_t>(n0) + (static_cast<int64_t>(n1) << 32);
}

SASSY_HD int lane_count(int64_t packed, int lane) {
  return static_cast<int>(lane ? packed >> 32 : packed & 0xFFFFFFFFLL);
}

// int64 words of a call's scratch: per block its two lanes' counts
// (pack_counts) and its output offset, per segment its map and entering
// state (two int32), then the total.
struct WordScratch {
  int64_t* counts;
  int64_t* offsets;
  int32_t* segs;    // (segments, 2): map, entering state
  int64_t* total;
};

inline int64_t word_scratch_words(const Grid& g) {
  return 2 * g.blocks() + g.segments() + 1;
}

inline WordScratch word_scratch_at(void* p, const Grid& g) {
  int64_t* w = static_cast<int64_t*>(p);
  WordScratch s;
  s.counts = w;
  s.offsets = w + g.blocks();
  s.segs = reinterpret_cast<int32_t*>(w + 2 * g.blocks());
  s.total = w + 2 * g.blocks() + g.segments();
  return s;
}

}  // namespace
