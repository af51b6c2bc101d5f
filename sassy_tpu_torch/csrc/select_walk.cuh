// The per-tile walk of the position-level candidate selection
// (select_positions.cu) and the records its scan composes, as
// __host__ __device__ functions: the kernels run them on the card, and a
// host build of this header (tests/torch_select_walk_host.cc) holds them
// to the plain versions, minima.select_candidates_plain and
// select_candidates_tiles_plain, without one.
//
// One walk over a tile (one text tile, or one (pattern, piece)) reads each
// word's vp and vm once and the cost of the tile's first word only: each
// next word's start cost is that plus popc(vp) - popc(vm) of the words
// before (the scan's own running sum). The state entering a tile (whether
// the last nonzero delta before it was +1) matters only up to the tile's
// first delta that feeds the state, so the walk runs two lanes in lockstep,
// one for each entering state, and yields a TileRec: the candidate count
// for either entering state, the state leaving for either (a constant, or
// the entering state when no delta fed it), and per group of words whether
// it holds a candidate and the state at its start where that is known.
// Composed in tile order (compose), the records give every tile's entering
// state and its output offset; emit_tile then walks only the flagged
// groups of a tile with its entering state and writes the candidates.

#pragma once

#include "select_common.cuh"

namespace {

// A tile's words fall into at most kGroups groups of group_words(nw).
constexpr int kGroups = 16;
// TileRec.bits: bit g (g < kGroups) group g holds a candidate for some
// entering state; bits kCodeShift + 2 g, 2 bits: the state code at group
// g's start (0: the entering state, 2: not up, 3: up); bits kMapShift + s:
// the state leaving when s enters.
constexpr int kCodeShift = 16;
constexpr int kMapShift = 48;
// Words whose vp and vm loads a walk issues before it steps through them.
constexpr int kAhead = 4;

SASSY_HD int group_words(int nw) { return (nw + kGroups - 1) / kGroups; }

// Whether the highest set bit of vp lies above that of vm (-1 for zero):
// the sign of the last nonzero delta of a word whose bits are vp (+1) and
// vm (-1), given vp | vm != 0 (minima._last_delta_up).
SASSY_HD bool last_delta_up(uint32_t vp, uint32_t vm) {
  return (31 - clz32(vp)) > (31 - clz32(vm));
}

// Bits b >= s of a word (s clamped to [0, 32]).
SASSY_HD uint32_t bits_from(int s) {
  if (s <= 0) return 0xFFFFFFFFu;
  if (s >= 32) return 0u;
  return 0xFFFFFFFFu << s;
}

struct TileRec {  // 16 bytes, one per (pattern, tile)
  int32_t n[2];   // candidates when the state entering is not up / up
  uint64_t bits;
};

// A map from the state entering a run of tiles to the state leaving it,
// with the candidates for either entering state: what the scan composes.
struct Agg {
  int64_t n[2];
  uint32_t map;  // bit s: the state leaving when s enters
};

SASSY_HD int leave(uint32_t map, int s) { return static_cast<int>((map >> s) & 1u); }

SASSY_HD Agg agg_identity() {
  Agg a;
  a.n[0] = a.n[1] = 0;
  a.map = 2u;  // 0 -> 0, 1 -> 1
  return a;
}

SASSY_HD Agg agg_of(const TileRec& r) {
  Agg a;
  a.n[0] = r.n[0];
  a.n[1] = r.n[1];
  a.map = static_cast<uint32_t>(r.bits >> kMapShift) & 3u;
  return a;
}

// The run a, then the run b.
SASSY_HD Agg compose(const Agg& a, const Agg& b) {
  Agg c;
  c.map = 0u;
  for (int s = 0; s < 2; ++s) {
    const int m = leave(a.map, s);
    c.n[s] = a.n[s] + b.n[m];
    c.map |= static_cast<uint32_t>(leave(b.map, m)) << s;
  }
  return c;
}

// A tile whose entering state is f whatever came before it (a text's
// first tile, a piece that starts a text or a chunk): both lanes become
// lane f's.
SASSY_HD TileRec force(TileRec r, int f) {
  const int n = r.n[f];
  const uint64_t out = static_cast<uint64_t>(leave(static_cast<uint32_t>(r.bits >> kMapShift), f));
  r.n[0] = r.n[1] = n;
  r.bits = (r.bits & ~(3ull << kMapShift)) | ((out * 3ull) << kMapShift);
  return r;
}

// A position or bound of a tile, local: it is compared with local
// positions 0 .. nw * 32 only (nw * 32 < 2^30), and a tile lies at most
// the overhang steps past its text end, so clamping to +-2^30 keeps every
// comparison and every overshoot, in 32-bit arithmetic.
SASSY_HD int local32(int64_t x) {
  const int64_t cap = int64_t{1} << 30;
  return static_cast<int>(x < -cap ? -cap : x > cap ? cap : x);
}

// One tile's walk over its local positions 0 .. nw * 32.
struct Walk {
  const uint32_t* vp;  // word 0 of the walk; words are sw apart
  const uint32_t* vm;
  const int32_t* cost;  // the cost at word 0's start (read once)
  int64_t sw;
  int nw;
  bool has0;  // local position 0 is walked, at cost c0
  int c0;
  int lo, hi;  // reported local positions [lo, hi]
  int gate;    // local positions below it do not feed the state
  int last;    // the local position whose lookahead always passes
  int tend;    // local text end: overshoot = position - tend
  int next;    // the delta after local position nw * 32
  // pieces: the state leaving the tile is its last raw delta at positions
  // (own_lo, own_hi] (minima.last_delta_codes), not the walk's own state
  bool own_code;
  int own_lo, own_hi;
};

// A lower bound of the raw cost at every position of a word whose start
// cost is cw: for each byte of the word, the sum of the deltas of the
// bytes before it less the byte's -1 bits (per-byte popcounts in one
// register, their running sums by a multiply). Never above cw less
// popc(vm), and near the true least cost where deltas are dense.
SASSY_HD int word_low(uint32_t vp, uint32_t vm, int cw) {
  uint32_t p = vp - ((vp >> 1) & 0x55555555u);
  uint32_t m = vm - ((vm >> 1) & 0x55555555u);
  p = (p & 0x33333333u) + ((p >> 2) & 0x33333333u);
  m = (m & 0x33333333u) + ((m >> 2) & 0x33333333u);
  p = (p + (p >> 4)) & 0x0F0F0F0Fu;
  m = (m + (m >> 4)) & 0x0F0F0F0Fu;
  const uint32_t before_p = p * 0x01010100u;  // byte b: the bytes < b's
  const uint32_t before_m = m * 0x01010100u;
  int low = cw;
  for (int b = 0; b < 32; b += 8) {
    const int v = static_cast<int>((before_p >> b) & 0xFFu) -
                  static_cast<int>((before_m >> b) & 0xFFu) -
                  static_cast<int>((m >> b) & 0xFFu);
    low = cw + v < low ? cw + v : low;
  }
  return low;
}

// Bits b of a word at local positions l0 + b + 1 in (lo, hi].
SASSY_HD uint32_t bits_in(int lo, int hi, int l0) {
  return bits_from(lo - l0) & ~bits_from(hi - l0);
}

// The walk's steps, in L lanes that differ only in the state entering:
// the cost, the overshoot and the pending candidate's position are shared.
// A word whose costs all exceed k (its start cost less popc(vm), else
// the tighter word_low, plus the overshoot at its first position) is
// skipped whole: its first delta
// settles the pending candidate, and the last word whose deltas fed the
// state is kept (lvp, lvm) and read only where the state is asked for.
template <int L, class Take>
struct Stepper {
  const Walk& w;
  Take& take;  // take(lane, local position, cost, group)
  int k;
  bool all_minima, over;
  float alpha;
  bool up[L];
  bool pend[L];  // a candidate at pend_lp, waiting for the next delta
  bool lazy;     // the state is that of lvp, lvm's last delta
  uint32_t lvp, lvm;
  int pend_lp, pend_cost, ov_prev, cw;

  SASSY_HD Stepper(const Walk& w_, Take& take_, int k_, bool all_minima_,
                   float alpha_)
      : w(w_), take(take_), k(k_), all_minima(all_minima_),
        over(alpha_ != 0.0f), alpha(alpha_), lazy(false), lvp(0), lvm(0),
        pend_lp(0), pend_cost(0), ov_prev(0), cw(0) {
    for (int l = 0; l < L; ++l) up[l] = pend[l] = false;
  }

  SASSY_HD int ov(int lp) const {
    return over && lp > w.tend
               ? static_cast<int>(overshoot_floor(alpha, lp - w.tend)) : 0;
  }

  // The state, once the skipped words' last delta is read.
  SASSY_HD void settle() {
    if (lazy) {
      const bool u = last_delta_up(lvp, lvm);
      for (int l = 0; l < L; ++l) up[l] = u;
      lazy = false;
    }
  }

  // Local position 0 (the boundary), at the walk's start.
  SASSY_HD void start0() {
    ov_prev = ov(0);
    pend_lp = 0;
    pend_cost = w.c0 + ov_prev;
    const bool in = w.lo <= 0 && w.hi >= 0 && pend_cost <= k;
    for (int l = 0; l < L; ++l) pend[l] = in && (all_minima || !up[l]);
  }

  // The pending candidate (of word group `group`), against the delta d
  // after it.
  SASSY_HD void resolve(int d, int group) {
    for (int l = 0; l < L; ++l) {
      if (pend[l] && (all_minima || d >= 1 || pend_lp == w.last)) {
        take(l, pend_lp, pend_cost, group);
      }
    }
  }

  // Word i (local positions 32 i + 1 .. 32 i + 32), its start cost in
  // cw; the pending candidate lies in word group gprev, the word in g.
  SASSY_HD void word(int i, uint32_t vp, uint32_t vm, int gprev, int g) {
    const int l0 = i * 32;
    const int pm = popc32(vm);
    const int ov1 = ov(l0 + 1);
    if (cw - pm + ov1 > k || word_low(vp, vm, cw) + ov1 > k) {
      // no position of the word costs <= k
      const bool inside = !over || l0 + 32 <= w.tend;
      int d0 = bit_delta(vp, vm, 0);
      if (!inside) d0 += ov1 - ov_prev;
      resolve(d0, gprev);
      for (int l = 0; l < L; ++l) pend[l] = false;
      if (!all_minima) {
        if (inside) {  // no overshoot step: the raw deltas feed the state
          const uint32_t f = bits_from(w.gate - l0 - 1);
          if (((vp | vm) & f) != 0) {
            lvp = vp & f;
            lvm = vm & f;
            lazy = true;
          }
        } else {  // the last nonzero delta with its overshoot step
          for (int b = 31; b >= 0 && l0 + b + 1 >= w.gate; --b) {
            const int d = bit_delta(vp, vm, b) + ov(l0 + b + 1) - ov(l0 + b);
            if (d != 0) {
              for (int l = 0; l < L; ++l) up[l] = d > 0;
              lazy = false;
              break;
            }
          }
        }
      }
      ov_prev = ov(l0 + 32);
    } else {
      settle();
      int raw_cost = cw;
#pragma unroll 1
      for (int b = 0; b < 32; ++b) {
        const int lp = l0 + b + 1;
        const int raw = bit_delta(vp, vm, b);
        const int ov_l = ov(lp);
        const int d = raw + ov_l - ov_prev;
        resolve(d, b == 0 ? gprev : g);
        raw_cost += raw;
        const int c = raw_cost + ov_l;
        if (!all_minima && lp >= w.gate && d != 0) {
          for (int l = 0; l < L; ++l) up[l] = d > 0;
        }
        const bool in = lp >= w.lo && lp <= w.hi && c <= k;
        for (int l = 0; l < L; ++l) pend[l] = in && (all_minima || !up[l]);
        pend_lp = lp;
        pend_cost = c;
        ov_prev = ov_l;
      }
    }
    cw += popc32(vp) - pm;
  }
};

struct CountTake {
  int32_t n[2];
  uint64_t flags;
  SASSY_HD void operator()(int l, int, int, int group) {
    ++n[l];
    flags |= 1ull << group;
  }
};

// The tile's record for either entering state, in one read of its words.
SASSY_HD TileRec count_tile(const Walk& w, int k, bool all_minima,
                            float alpha) {
  CountTake t;
  t.n[0] = t.n[1] = 0;
  t.flags = 0;
  const int G = group_words(w.nw);
  Stepper<2, CountTake> s(w, t, k, all_minima, alpha);
  s.up[1] = true;
  if (w.has0) {
    s.start0();
  } else {
    s.ov_prev = s.ov(0);
  }
  s.cw = w.cost[0];
  uint64_t codes = 0;
  uint32_t ovp = 0, ovm = 0;  // the last word with a raw owned delta
  int group = -1, left = 0;
  const uint32_t* pv = w.vp;
  const uint32_t* pm = w.vm;
  for (int i0 = 0; i0 < w.nw; i0 += kAhead) {
    uint32_t p[kAhead], m[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      p[j] = m[j] = 0;
      if (i0 + j < w.nw) {
        p[j] = *pv;
        m[j] = *pm;
        pv += w.sw;
        pm += w.sw;
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int i = i0 + j;
      if (i < w.nw) {
        const int gprev = group < 0 ? 0 : group;
        if (left == 0) {  // a group starts here
          ++group;
          left = G;
          s.settle();
          if (s.up[0] == s.up[1]) {
            codes |= static_cast<uint64_t>(2 + s.up[0])
                     << (kCodeShift + 2 * group);
          }
        }
        --left;
        if (w.own_code) {
          const uint32_t f = bits_in(w.own_lo, w.own_hi, i * 32);
          if (((p[j] | m[j]) & f) != 0) {
            ovp = p[j] & f;
            ovm = m[j] & f;
          }
        }
        s.word(i, p[j], m[j], gprev, group);
      }
    }
  }
  s.resolve(w.next, group < 0 ? 0 : group);
  s.settle();
  uint32_t map;
  if (all_minima) {
    map = 2u;
  } else if (w.own_code) {
    map = (ovp | ovm) == 0 ? 2u : last_delta_up(ovp, ovm) ? 3u : 0u;
  } else {
    map = static_cast<uint32_t>(s.up[0]) | (static_cast<uint32_t>(s.up[1]) << 1);
  }
  TileRec r;
  r.n[0] = t.n[0];
  r.n[1] = t.n[1];
  r.bits = t.flags | codes | (static_cast<uint64_t>(map) << kMapShift);
  return r;
}

// Where a walk writes: (4, N) [q; t; base + position; cost] with qt, else
// (2, N) [base + position; cost], from column at.
struct Sink {
  int64_t* out;
  int64_t N;
  int64_t at;
  int64_t base;
  int q, t;
  bool qt;
  SASSY_HD void operator()(int, int lp, int c, int) {
    if (qt) {
      out[at] = q;
      out[N + at] = t;
      out[2 * N + at] = base + lp;
      out[3 * N + at] = c;
    } else {
      out[at] = base + lp;
      out[N + at] = c;
    }
    ++at;
  }
};

// The tile's candidates for the entering state `up`, from its record's
// bits: only the groups that hold one are walked, each from its own
// first word's cost and its start state.
SASSY_HD void emit_tile(const Walk& w, int k, bool all_minima, float alpha,
                        uint64_t bits, bool up, Sink& sink) {
  const int G = group_words(w.nw);
  for (int g = 0; g * G < w.nw; ++g) {
    if (((bits >> g) & 1u) == 0) continue;
    const int i0 = g * G;
    const int i1 = i0 + G < w.nw ? i0 + G : w.nw;
    const int code = static_cast<int>((bits >> (kCodeShift + 2 * g)) & 3u);
    Stepper<1, Sink> s(w, sink, k, all_minima, alpha);
    s.up[0] = code != 0 ? (code & 1) != 0 : up;
    if (g == 0 && w.has0) {
      s.start0();
    } else {
      s.ov_prev = s.ov(i0 * 32);
    }
    s.cw = w.cost[i0 * w.sw];
    for (int i = i0; i < i1; ++i) {
      s.word(i, w.vp[i * w.sw], w.vm[i * w.sw], g, g);
    }
    if (s.pend[0]) {  // the group's last position: the next word's first delta
      int d = w.next;
      if (i1 < w.nw) {
        const int l = i1 * 32;
        d = bit_delta(w.vp[i1 * w.sw], w.vm[i1 * w.sw], 0) + s.ov(l + 1) - s.ov(l);
      }
      s.resolve(d, g);
    }
  }
}

// ---- select_candidates: the tiles of one text ---------------------------

struct TextArgs {
  const uint32_t* vp;  // (NW, T), tiles adjacent, rows sw apart
  const uint32_t* vm;
  const int32_t* cost;
  int64_t sw;
  int T, W, halo, k;
  bool all_minima, gated;
  int seed;  // the state entering tile 0: 1 up
  float alpha;
  int64_t boundary_m, n_text, max_pos, min_pos, owned_end;
};

// Tile 0 owns window words [0, W), tile t >= 1 words [halo, halo + W):
// the flat positions t * W * 32 + 1 .. (t + 1) * W * 32.
SASSY_HD Walk walk_of(const TextArgs& a, int64_t t) {
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
  w.c0 = static_cast<int>(a.boundary_m);
  w.lo = local32(a.min_pos - base);
  w.hi = local32((a.owned_end < a.max_pos ? a.owned_end : a.max_pos) - base);
  w.gate = a.gated ? local32(a.min_pos - base) : 0;
  w.last = local32(a.max_pos - base);
  w.tend = local32(a.n_text - base);
  w.next = 1;
  if (t + 1 < a.T) {
    const int64_t nc = static_cast<int64_t>(a.halo) * a.sw + t + 1;
    w.next = bit_delta(a.vp[nc], a.vm[nc], 0);
    if (a.alpha != 0.0f) {
      w.next += static_cast<int>(overshoot_floor(a.alpha, span + 1 - w.tend) -
                                 overshoot_floor(a.alpha, span - w.tend));
    }
  }
  w.own_code = false;
  w.own_lo = w.own_hi = 0;
  return w;
}

// Whether the state entering tile t is fixed (in *f) whatever came before.
SASSY_HD bool forced(const TextArgs& a, int64_t t, int* f) {
  *f = a.seed;
  return !a.all_minima && t == 0;
}

SASSY_HD Sink sink_of(const TextArgs& a, int64_t t, int64_t* out,
                      int64_t N, int64_t at) {
  Sink s = {out, N, at, t * a.W * 32, 0, static_cast<int>(t), false};
  return s;
}

// ---- select_candidates_tiles: Q patterns over T pieces ---------------------

struct PieceArgs {
  const uint32_t* vp;  // (Q, NW, T), patterns sq apart, rows sw apart
  const uint32_t* vm;
  const int32_t* cost;
  int64_t sq, sw;
  const int32_t* boundary0;  // (Q, T)
  const int64_t* text_end;   // (T,)
  const int32_t* valid_from;
  const int32_t* valid_to;
  const int32_t* islast;
  const int64_t* pos_base;
  const int32_t* state0;     // (Q, T) the state of a piece that resets; null: 0
  const uint8_t* is_start;   // (T,) the pieces that reset; null: every piece
  const int32_t* carry;      // (Q,) the code entering piece 0 (3 up); null: 0
  int Q, NW, T, k;
  bool all_minima;
  float alpha;
};

// Piece (q, t) = item q * T + t walks its window positions 0 .. NW * 32;
// it reports (valid_from, valid_to]; deltas at or below valid_from (the
// halo) do not feed its state; the delta past the window is +1.
SASSY_HD Walk walk_of(const PieceArgs& a, int64_t item) {
  const int q = static_cast<int>(item / a.T);
  const int t = static_cast<int>(item - static_cast<int64_t>(q) * a.T);
  const int64_t col = q * a.sq + t;
  const int64_t vf = a.valid_from[t];
  Walk w;
  w.vp = a.vp + col;
  w.vm = a.vm + col;
  w.cost = a.cost + col;
  w.sw = a.sw;
  w.nw = a.NW;
  w.has0 = true;
  w.c0 = a.boundary0[item];
  w.lo = local32(vf + 1);
  w.hi = local32(a.valid_to[t]);
  w.gate = local32(vf + 1);
  w.last = local32(a.islast[t]);
  w.tend = local32(a.text_end[t]);
  w.next = 1;
  w.own_code = true;
  w.own_lo = local32(vf);
  w.own_hi = local32(a.valid_to[t]);
  return w;
}

SASSY_HD bool forced(const PieceArgs& a, int64_t item, int* f) {
  const int t = static_cast<int>(item % a.T);
  *f = 0;
  if (a.all_minima) return false;
  if (a.is_start == nullptr || a.is_start[t] != 0) {
    *f = a.state0 != nullptr && a.state0[item] > 0;
    return true;
  }
  if (t == 0) {
    *f = a.carry != nullptr && (a.carry[item / a.T] & 3) == 3;
    return true;
  }
  return false;
}

SASSY_HD Sink sink_of(const PieceArgs& a, int64_t item, int64_t* out,
                      int64_t N, int64_t at) {
  const int q = static_cast<int>(item / a.T);
  const int t = static_cast<int>(item - static_cast<int64_t>(q) * a.T);
  Sink s = {out, N, at, a.pos_base[t], q, t, true};
  return s;
}

SASSY_HD int32_t carry_code(const TextArgs&, int64_t, int leaving) {
  return leaving ? 3 : 0;
}

// The code of the state leaving pattern q's last piece (3 up, else 0); with
// all_minima, where no state is kept, the code carried in.
SASSY_HD int32_t carry_code(const PieceArgs& a, int64_t q, int leaving) {
  if (a.all_minima) return a.carry != nullptr ? a.carry[q] : 0;
  return leaving ? 3 : 0;
}

// ---- both ------------------------------------------------------------------

// The arguments of the C entry points (select_positions.cu), as the kernels
// take them.
inline TextArgs text_args(const void* vp, const void* vm, const void* cost,
                          long long sw, long long boundary_m,
                          long long n_text, long long max_pos,
                          long long min_pos, long long owned_end, int T,
                          int W, int halo, int k, int all_minima, int gated,
                          int seed, float alpha) {
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
  a.seed = seed != 0;
  a.alpha = alpha;
  a.boundary_m = boundary_m;
  a.n_text = n_text;
  a.max_pos = max_pos;
  a.min_pos = min_pos;
  a.owned_end = owned_end;
  return a;
}

inline PieceArgs piece_args(const void* vp, const void* vm, const void* cost,
                            const void* boundary0, const void* text_end,
                            const void* valid_from, const void* valid_to,
                            const void* islast, const void* pos_base,
                            const void* state0, const void* is_start,
                            const void* carry, long long sq, long long sw,
                            int Q, int NW, int T, int k, int all_minima,
                            float alpha) {
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
  a.is_start = static_cast<const uint8_t*>(is_start);
  a.carry = static_cast<const int32_t*>(carry);
  a.Q = Q;
  a.NW = NW;
  a.T = T;
  a.k = k;
  a.all_minima = all_minima != 0;
  a.alpha = alpha;
  return a;
}

// Item `item`'s record, forced where its entering state is fixed (the
// kernels' first launch).
template <class Args>
SASSY_HD TileRec record_of(const Args& a, int64_t item) {
  TileRec r = count_tile(walk_of(a, item), a.k, a.all_minima, a.alpha);
  int f;
  return forced(a, item, &f) ? force(r, f) : r;
}

// Item `item`'s candidates, written from column `at`, given its record and
// the state `s` the records before it leave (the kernels' last launch).
template <class Args>
SASSY_HD void emit_item(const Args& a, int64_t item, const TileRec& r, int s,
                        int64_t* out, int64_t N, int64_t at) {
  int f;
  const int up = forced(a, item, &f) ? f : s;
  Sink sink = sink_of(a, item, out, N, at);
  emit_tile(walk_of(a, item), a.k, a.all_minima, a.alpha, r.bits, up != 0,
            sink);
}

}  // namespace
