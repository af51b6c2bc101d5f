// The host finish's traceback (trace.cu) as __host__ __device__ functions:
// for one candidate, its window read from the strand's bit-planes, the
// windowed DP filled as Myers words and the greedy walk back from its end
// on the delta words the fill left. The kernel runs one candidate a thread
// on the card; a host build of this header (tests/torch_trace_host.cc)
// runs the candidates one after another and holds the result to the plain
// version (traceback.trace_plain) without one.
//
// What one candidate computes is what the plain version's _fill_batch and
// _walk_batch compute for its column of the batch, bit for bit:
//
// - Its window is the `wlen` positions from `off` of its text in the
//   strand (the text read backwards for the reverse strand: its own
//   planes, never the forward ones). Code bit p of strand position x is
//   bit x % 32 of planes[p, word0 + x / 32], word0 the text's first plane
//   word. Only the columns the walk can reach are filled: it starts at
//   column i0 = min(end - off, wlen) and never moves right, and no column
//   left of it reads one right of it. Window word u holds positions 32 u
//   .. 32 u + 31, two plane words funnel-shifted by the window's start
//   (trace_window_word); positions past i0 are don't-cares, a word at or
//   past L reads as zero.
// - The fill: D[0, i] = 0, D[j, 0] = the left boundary's cost of row j,
//   D[j, i] = min(D[j-1, i-1] + !match, D[j-1, i] + 1, D[j, i-1] + 1),
//   match (p & t) != 0 for iupac and dna, p == t (the folded bytes) for
//   ascii. Row j is one Myers step a window word (myers_word.cuh) on the
//   row's eq word, the carry entering word 0 the boundary's step
//   D[j, 0] - D[j-1, 0], as the scans take init_h_deltas. The step's two
//   pairs of delta words are kept a (row, word): along the row,
//   D[j, i] - D[j, i-1], and down the column, D[j, i] - D[j-1, i]
//   (TraceCell: 16 bytes for 32 cells), in a scratch laid out by
//   anti-diagonal (trace_at). The window's words stay in registers,
//   kTraceGroupMax at most (a longer window is filled in groups of words,
//   the carry into a group's first word read back from the cell to its
//   left), and step in a wavefront (trace_group): at time s word g takes
//   row s - g, so that a thread has its words' steps to issue side by
//   side, not one chain of them.
// - The walk: an end past the window walks straight back along the 'N'
//   diagonal (end overshoot: pattern_end = m - over, its cost from the
//   table); it starts from g = D[m - over, i0], the boundary plus the
//   row's deltas up to i0 (popcounts), and keeps g = D[j, i]: each
//   neighbour is g less one or two delta bits, read from kTraceStageRows
//   rows of cells staged at once in fast memory. From (j, i) one op a step
//   in the fixed preference = then X then D then I (reference
//   trace.rs:338-365), the = step's match tested on the pattern code and
//   the window position's code; with alpha a stop at column 0 that leaves
//   the pattern prefix hanging off the text start (start overshoot, its
//   cost from the table); `failed` where no step is consistent or cost is
//   left at the end.
//
// The overhang costs come from the host as int32 tables over 0..m (the
// left boundary, the start overshoot's float32 floor, the end
// overshoot's), so no float is computed here. The Myers words take a left
// boundary that starts at 0 and steps by -1, 0 or 1 (trace_tables' does:
// steps of 0 or 1); a candidate that fills words under another is failed.

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define TRACE_HD __host__ __device__ __forceinline__
#else
#define TRACE_HD inline
#endif

#include "myers_word.cuh"

namespace {

constexpr int kTraceThreads = 128;
// int32 fields a candidate's output row starts with: its start in the
// window, total cost, pattern start, pattern end, failed; its ops follow
// as int8, in walk order, -1 past the walk's end.
constexpr int kTraceFields = 5;
constexpr int kTraceMaxPlanes = 8;
constexpr int kTraceEqAnd = 0;   // iupac, dna
constexpr int kTraceEqByte = 1;  // ascii
// Window words a fill keeps in registers while it steps a row.
constexpr int kTraceGroupMax = 8;
// Rows of cells (and their pattern codes) the walk stages at once in fast
// memory: the row it stands on and those above it.
constexpr int kTraceStageRows = 16;
constexpr int kOpMatch = 0;
constexpr int kOpSub = 1;
constexpr int kOpDel = 2;
constexpr int kOpIns = 3;

// One (row j, window word u) of a candidate's DP as the Myers step leaves
// it: bit b is column i = 32 u + b + 1.
struct alignas(16) TraceCell {
  uint32_t rp, rm;  // D[j, i] - D[j, i - 1] is +1 / -1
  uint32_t cp, cm;  // D[j, i] - D[j - 1, i] is +1 / -1
};

struct TraceArgs {
  const uint32_t* planes;  // (rows, L) words, rows >= P
  int64_t L;
  int P;
  const uint8_t* pcodes;  // (Q, m) pattern codes
  const int64_t* cand;    // (5, B): pattern, word0, off, wlen, end
  int64_t B;
  const int32_t* tables;  // (3, m + 1): left boundary, start, end overshoot
  int m;
  int w;             // the fill length: each window's most columns
  int nw;            // window words a row of cells: ceil(w / 32)
  bool alpha_on;     // the start overshoot applies
  int32_t* out;      // (B, stride) int32
  int64_t stride;    // int32 words a row: kTraceFields + the ops' words
  TraceCell* cells;  // scratch: (m + nwp) x nwp cells of `chunk`
                     // candidates, nwp = nw rounded up to the fill's words
                     // a group
  int64_t chunk;     // the scratch's interleave: cell (r, u) of slot t at
                     // trace_at(r, u, nwp, chunk) + t
};

TRACE_HD bool trace_match(int eq, uint32_t p, uint32_t t) {
  return eq == kTraceEqByte ? p == t : (p & t) != 0u;
}

TRACE_HD uint32_t trace_bit(uint32_t word, int b) { return (word >> b) & 1u; }

TRACE_HD int trace_popc(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// The low word of (hi:lo) >> s, s in 0..31.
TRACE_HD uint32_t trace_shr(uint32_t lo, uint32_t hi, int s) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(lo, hi, s);
#else
  return static_cast<uint32_t>(
      ((static_cast<uint64_t>(hi) << 32) | lo) >> s);
#endif
}

// Window word u of the window from bit position `base` of the planes
// (base = 32 word0 + off): plane p's bits of positions base + 32 u ..
// base + 32 u + 31 in x[p], planes P.. NP - 1 zero. A word at or past L
// reads as zero.
template <int NP>
TRACE_HD void trace_window_word(const uint32_t* planes, int64_t L, int P,
                                int64_t base, int u, uint32_t (&x)[NP]) {
  const int64_t a = (base >> 5) + u;
  const int s = static_cast<int>(base & 31);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const uint32_t* row = planes + p * L;
    const uint32_t lo = p < P && a < L ? row[a] : 0u;
    const uint32_t hi = p < P && a + 1 < L ? row[a + 1] : 0u;
    x[p] = trace_shr(lo, hi, s);
  }
}

// The code at bit b of a window word's planes.
template <int NP>
TRACE_HD uint32_t trace_code(const uint32_t (&x)[NP], int b) {
  uint32_t code = 0;
#pragma unroll
  for (int p = 0; p < NP; ++p) code |= trace_bit(x[p], b) << p;
  return code;
}

// The NP masks of pattern code pc: all ones where pc has bit p.
template <int NP>
TRACE_HD void trace_masks(uint32_t pc, uint32_t (&sel)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) sel[p] = 0u - trace_bit(pc, p);
}

// The eq word of a pattern code (its masks) against a window word's
// planes: OR of the planes of its bits (iupac, dna), or every plane equal
// to its bit (ascii). Planes past P are zero, as in the codes trace_match
// reads.
template <int EQ, int NP>
TRACE_HD uint32_t trace_eq(const uint32_t (&x)[NP],
                           const uint32_t (&sel)[NP]) {
  uint32_t acc = 0;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    acc |= EQ == kTraceEqAnd ? x[p] & sel[p] : x[p] ^ sel[p];
  }
  return EQ == kTraceEqAnd ? acc : ~acc;
}

// Where cell (r, u) of slot 0 lies in the scratch: by anti-diagonal r + u,
// nwp words a diagonal, so that a time step of the fill's wavefront stores
// to one run of cells.
TRACE_HD int64_t trace_at(int r, int u, int nwp, int64_t C) {
  return (static_cast<int64_t>(r + u) * nwp + u) * C;
}

// One group of G window words from word u0 (ng of them in the window) of
// rows 1..j0 into their cells, the rows' last state left in vp/vm. The
// words step in a wavefront: at time s word g takes row s - g, its carry
// the one word g - 1 left at time s - 1 and its pattern code's masks the
// ones word g - 1 had, so that a time step's G Myers steps are independent
// of each other. No branch inside a time step: a word outside its rows
// steps all the same, keeps its state and stores into a cell no one reads
// (its row is below 1 or past j0, or its word past the window). The carry
// into word 0 of row r is the boundary's step (FIRST) or bit 31 of the
// column deltas of the cell to its left; `bad` where the boundary steps by
// more than 1.
template <int EQ, int NP, int G, bool FIRST>
TRACE_HD void trace_group(const TraceArgs& a, TraceCell* cells, int64_t C,
                          int nwp, const uint8_t* pat, int64_t base, int u0,
                          int ng, int j0, bool& bad, uint32_t (&vp)[G],
                          uint32_t (&vm)[G]) {
  const int32_t* boundary = a.tables;
  uint32_t x[G][NP], sel[G][NP];
  uint32_t hp[G], hm[G];  // the carry into each word
#pragma unroll
  for (int g = 0; g < G; ++g) {
    vp[g] = vm[g] = hp[g] = hm[g] = 0u;  // row 0: D[0, i] = 0
#pragma unroll
    for (int p = 0; p < NP; ++p) sel[g][p] = 0u;
    if (g < ng) {
      trace_window_word<NP>(a.planes, a.L, a.P, base, u0 + g, x[g]);
    } else {
#pragma unroll
      for (int p = 0; p < NP; ++p) x[g][p] = 0u;
    }
  }
  // row r's carry into word 0 and pattern code, loaded a time step ahead
  auto carry = [&](int r, uint32_t& cp, uint32_t& cm) {
    if (FIRST) {
      const int32_t d = boundary[r] - boundary[r - 1];
      bad |= d < -1 || d > 1;
      cp = d > 0 ? 1u : 0u;
      cm = d < 0 ? 1u : 0u;
    } else {
      const TraceCell c = cells[trace_at(r, u0 - 1, nwp, C)];
      cp = c.cp >> 31;
      cm = c.cm >> 31;
    }
  };
  uint32_t cp_n, cm_n;
  carry(1, cp_n, cm_n);
  uint32_t pc_n = pat[0];
  // time s's cells: word g's at diag[g C]
  TraceCell* diag = cells + trace_at(1, u0, nwp, C);
  const int64_t diag_step = static_cast<int64_t>(nwp) * C;
  for (int s = 1; s < j0 + ng; ++s, diag += diag_step) {
#pragma unroll
    for (int g = G - 1; g > 0; --g) {
#pragma unroll
      for (int p = 0; p < NP; ++p) sel[g][p] = sel[g - 1][p];
    }
    trace_masks<NP>(pc_n, sel[0]);
    hp[0] = cp_n;
    hm[0] = cm_n;
    const int next = s < j0 ? s + 1 : j0;
    carry(next, cp_n, cm_n);
    pc_n = pat[next - 1];
    uint32_t op[G], om[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int r = s - g;
      const bool on = g < ng && r >= 1 && r <= j0;
      uint32_t nvp = vp[g], nvm = vm[g], hp_o, hm_o;
      myers_step(trace_eq<EQ, NP>(x[g], sel[g]), hp[g], hm[g], nvp, nvm,
                 hp_o, hm_o);
      op[g] = hp_o >> 31;
      om[g] = hm_o >> 31;
      vp[g] = on ? nvp : vp[g];
      vm[g] = on ? nvm : vm[g];
      diag[g * C] = TraceCell{nvp, nvm, hp_o, hm_o};
    }
#pragma unroll
    for (int g = G - 1; g > 0; --g) {
      hp[g] = op[g - 1];
      hm[g] = om[g - 1];
    }
  }
}

// Fill rows 1..j0 of words 0..ceil(i0 / 32) - 1 of one candidate into its
// cells (slot pointer `cells`, interleave C, nwp words a diagonal), G
// words at a time. Returns D[j0, i0]; sets `bad` where the left boundary
// does not step by -1, 0 or 1 from 0.
template <int EQ, int NP, int G>
TRACE_HD int32_t trace_fill(const TraceArgs& a, TraceCell* cells, int64_t C,
                            int nwp, const uint8_t* pat, int64_t base, int i0,
                            int j0, bool& bad) {
  const int32_t* boundary = a.tables;
  const int nwc = (i0 + 31) >> 5;
  int32_t row_sum = 0;  // row j0's deltas over columns 1..i0
  if (nwc > 0 && boundary[0] != 0) bad = true;
  for (int u0 = 0; u0 < nwc && j0 > 0; u0 += G) {
    const int ng = nwc - u0 < G ? nwc - u0 : G;
    uint32_t vp[G], vm[G];
    if (u0 == 0) {
      trace_group<EQ, NP, G, true>(a, cells, C, nwp, pat, base, u0, ng, j0,
                                   bad, vp, vm);
    } else {
      trace_group<EQ, NP, G, false>(a, cells, C, nwp, pat, base, u0, ng, j0,
                                    bad, vp, vm);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < ng) {
        const int cols = i0 - 32 * (u0 + g);
        const uint32_t keep = cols >= 32 ? ~0u : (1u << cols) - 1u;
        row_sum += trace_popc(vp[g] & keep) - trace_popc(vm[g] & keep);
      }
    }
  }
  return boundary[j0] + row_sum;
}

// Candidate b0 + t, in scratch slot t: fill and walk; write its output
// row. `stage` and `stage_codes`: the walk's kTraceStageRows cells and
// codes, element r at r ss (the block's shared memory on the card).
template <int EQ, int NP, int G>
TRACE_HD void trace_one(const TraceArgs& a, int64_t b0, int64_t t,
                        TraceCell* stage, uint32_t* stage_codes, int ss) {
  const int64_t b = b0 + t;
  const int64_t pid = a.cand[b];
  const int64_t word0 = a.cand[a.B + b];
  const int64_t off = a.cand[2 * a.B + b];
  const int64_t wlen = a.cand[3 * a.B + b];
  const int64_t rel_end = a.cand[4 * a.B + b] - off;
  const int m = a.m;
  const int64_t C = a.chunk;
  const int nwp = (a.nw + G - 1) / G * G;  // words a diagonal of cells
  const int32_t* boundary = a.tables;
  const int32_t* start_cost = a.tables + (m + 1);
  const int32_t* end_cost = a.tables + 2 * (m + 1);
  const uint8_t* pat = a.pcodes + pid * m;
  TraceCell* cells = a.cells + t;
  const int64_t base = word0 * 32 + off;

  // end overshoot: the walk starts at (m - over, min(rel_end, wlen))
  const int over = static_cast<int>(rel_end > wlen ? rel_end - wlen : 0);
  int i = static_cast<int>(rel_end - over);
  int j = m - over;
  // a window longer than the fill length, or an end before it or more
  // than m past it, is no candidate of this call: failed, not filled
  bool bad = i < 0 || i > a.w || j < 0;
  int32_t g = bad ? 0 : trace_fill<EQ, NP, G>(a, cells, C, nwp, pat, base,
                                               i, j, bad);
  const int32_t total = g + (bad ? 0 : end_cost[over]);

  int32_t* o = a.out + b * a.stride;
  int8_t* ops = reinterpret_cast<int8_t*>(o + kTraceFields);
  int n = 0;
  int pattern_start = 0;
  // the cells of rows sj, sj - 1, .., sj - kTraceStageRows + 1 at word su
  // staged in fast memory (a row below 1 reads as zero: D[0, i] = 0) with
  // those rows' pattern codes, all loaded at once; word su's planes
  uint32_t x[NP];
  int sj = -1, su = -1;
  while (j > 0 && !bad) {
    int op;
    if (i == 0) {
      if (a.alpha_on) {
        // start overshoot: the pattern's first j chars hang off the text
        // start (trace.rs:322-335)
        pattern_start = j;
        g -= start_cost[j];
        break;
      }
      // only an I step: D[j - 1, 0] is the boundary's
      op = boundary[j] - boundary[j - 1] == 1 ? kOpIns : -1;
    } else {
      const int u = (i - 1) >> 5;
      const int b = (i - 1) & 31;
      if (u != su || sj - j >= kTraceStageRows - 1) {
        // rows j and j - 1 lie outside the stage: stage from row j
#pragma unroll
        for (int r = 0; r < kTraceStageRows; ++r) {
          const int row = j - r;
          stage[r * ss] = row >= 1 ? cells[trace_at(row, u, nwp, C)]
                                   : TraceCell{0, 0, 0, 0};
          stage_codes[r * ss] = row >= 1 ? pat[row - 1] : 0u;
        }
        if (u != su) trace_window_word<NP>(a.planes, a.L, a.P, base, u, x);
        su = u;
        sj = j;
      }
      const int k = sj - j;  // row j's place in the stage
      const TraceCell c0 = stage[k * ss];
      const TraceCell c1 = stage[(k + 1) * ss];
      // D[j, i - 1] = g - along, D[j - 1, i] = g - down, D[j - 1, i - 1] =
      // g - diag (down and the row above's along)
      const int32_t along = static_cast<int32_t>(trace_bit(c0.rp, b))
                            - static_cast<int32_t>(trace_bit(c0.rm, b));
      const int32_t down = static_cast<int32_t>(trace_bit(c0.cp, b))
                           - static_cast<int32_t>(trace_bit(c0.cm, b));
      const int32_t diag = down
                           + static_cast<int32_t>(trace_bit(c1.rp, b))
                           - static_cast<int32_t>(trace_bit(c1.rm, b));
      const bool match =
          trace_match(EQ, stage_codes[k * ss], trace_code<NP>(x, b));
      op = diag == 0 && match ? kOpMatch
           : diag == 1        ? kOpSub
           : along == 1       ? kOpDel
           : down == 1        ? kOpIns
                              : -1;
    }
    if (op < 0) {
      bad = true;
      break;
    }
    ops[n++] = static_cast<int8_t>(op);
    g -= op != kOpMatch;
    j -= op != kOpDel;
    i -= op != kOpIns;
  }
  // -1 in every op byte past the walk: to the next word, then words
  for (; n & 3; ++n) ops[n] = -1;
  for (int64_t q = kTraceFields + (n >> 2); q < a.stride; ++q) o[q] = -1;
  o[0] = i;
  o[1] = total;
  o[2] = pattern_start;
  o[3] = m - over;
  o[4] = (bad || g != 0) ? 1 : 0;
}

// Calls f.template run<EQ, NP, G>() for the instantiation that takes these
// arguments: the eq, the planes it reads (4 or 8) and the words a row of
// the fill keeps in registers (nw, at most kTraceGroupMax). Host code: the
// kernel's launch, the host build.
static_assert(kTraceGroupMax == 8, "trace_dispatch_group's cases");

template <int EQ, int NP, typename F>
int trace_dispatch_group(int nw, F& f) {
  switch (nw) {
    case 0:
    case 1: return f.template run<EQ, NP, 1>();
    case 2: return f.template run<EQ, NP, 2>();
    case 3: return f.template run<EQ, NP, 3>();
    case 4: return f.template run<EQ, NP, 4>();
    case 5: return f.template run<EQ, NP, 5>();
    case 6: return f.template run<EQ, NP, 6>();
    case 7: return f.template run<EQ, NP, 7>();
    default: return f.template run<EQ, NP, kTraceGroupMax>();
  }
}

template <typename F>
int trace_dispatch(int eq, int P, int nw, F& f) {
  if (eq == kTraceEqByte) return trace_dispatch_group<kTraceEqByte, 8>(nw, f);
  if (P <= 4) return trace_dispatch_group<kTraceEqAnd, 4>(nw, f);
  return trace_dispatch_group<kTraceEqAnd, 8>(nw, f);
}

}  // namespace
