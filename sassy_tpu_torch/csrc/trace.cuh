// The host finish's traceback (trace.cu) as __host__ __device__ functions:
// for one candidate, its window's codes read from the strand's bit-planes,
// the windowed DP fill and the greedy walk back from its end. The kernel
// runs one candidate a thread on the card; a host build of this header
// (tests/torch_trace_host.cc) runs the candidates one after another and
// holds the result to the plain version (traceback.trace_plain) without
// one.
//
// What one candidate computes is what the plain version's _fill_batch and
// _walk_batch compute for its column of the batch, bit for bit:
//
// - Its window is the `wlen` positions from `off` of its text in the
//   strand (the text read backwards for the reverse strand: its own
//   planes, never the forward ones). Code bit p of strand position x is
//   bit x % 32 of planes[p, word0 + x / 32], word0 the text's first plane
//   word (trace_codes). Only the columns the walk can reach are decoded and
//   filled: it starts at column min(end - off, wlen) and never moves right,
//   and no column left of it reads one right of it.
// - The fill: E[j, i] = D[j, i] - i, the cost matrix less its column,
//   E[0, i] = -i, E[j, 0] = the left boundary's cost of row j, and
//   E[j, i] = min(E[j-1, i-1] - match, E[j-1, i] + 1, E[j, i-1]), match
//   (p & t) != 0 for iupac and dna, p == t (the folded bytes) for ascii.
// - The walk: an end past the window walks straight back along the 'N'
//   diagonal (end overshoot: pattern_end = m - over, its cost from the
//   table); then from (j, i) one op a step in the fixed preference = then
//   X then D then I (reference trace.rs:338-365), with alpha a stop at
//   column 0 that leaves the pattern prefix hanging off the text start
//   (start overshoot, its cost from the table); `failed` where no step is
//   consistent or cost is left at the end. Where the plain version reads
//   a wrapped index and masks it, this tests bounds.
//
// The overhang costs come from the host as int32 tables over 0..m (the
// left boundary, the start overshoot's float32 floor, the end
// overshoot's), so no float is computed here.

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define TRACE_HD __host__ __device__ __forceinline__
#else
#define TRACE_HD inline
#endif

namespace {

constexpr int kTraceThreads = 128;
// int32 fields a candidate's output row starts with: its start in the
// window, total cost, pattern start, pattern end, failed; its ops follow
// as int8, in walk order, -1 past the walk's end.
constexpr int kTraceFields = 5;
constexpr int kTraceMaxPlanes = 8;
constexpr int kTraceEqAnd = 0;   // iupac, dna
constexpr int kTraceEqByte = 1;  // ascii
// Columns whose E of the row above (and codes) a fill loads before it
// steps through them.
constexpr int kTraceAhead = 8;
constexpr int kOpMatch = 0;
constexpr int kOpSub = 1;
constexpr int kOpDel = 2;
constexpr int kOpIns = 3;

struct TraceArgs {
  const uint32_t* planes;  // (rows, L) words, rows >= P
  int64_t L;
  int P;
  int eq;
  const uint8_t* pcodes;  // (Q, m) pattern codes
  const int64_t* cand;    // (5, B): pattern, word0, off, wlen, end
  int64_t B;
  const int32_t* tables;  // (3, m + 1): left boundary, start, end overshoot
  int m;
  int w;             // the fill length: each window's most columns
  bool alpha_on;     // the start overshoot applies
  int32_t* out;      // (B, stride) int32
  int64_t stride;    // int32 words a row: kTraceFields + the ops' words
  int32_t* E;        // scratch: (m + 1) (w + 1) cells of `chunk` candidates
  uint8_t* codes;    // scratch: w codes of `chunk` candidates
  int64_t chunk;     // the scratch's interleave: cell c of slot t at
                     // c chunk + t
};

TRACE_HD bool trace_match(int eq, uint32_t p, uint32_t t) {
  return eq == kTraceEqByte ? p == t : (p & t) != 0u;
}

// The codes of the n positions from bit position `base` of the planes
// (base = 32 word0 + off) into out[0], out[step], ...; each plane word is
// loaded once. A word at or past L reads as zero.
TRACE_HD void trace_codes(const uint32_t* planes, int64_t L, int P,
                          int64_t base, int n, uint8_t* out, int64_t step) {
  uint32_t wd[kTraceMaxPlanes];
  int64_t cur = -1;
  for (int c = 0; c < n; ++c) {
    const int64_t x = base + c;
    const int64_t word = x >> 5;
    if (word != cur) {
#pragma unroll
      for (int p = 0; p < kTraceMaxPlanes; ++p) {
        wd[p] = (p < P && word < L) ? planes[p * L + word] : 0u;
      }
      cur = word;
    }
    const int bit = static_cast<int>(x & 31);
    uint32_t code = 0;
#pragma unroll
    for (int p = 0; p < kTraceMaxPlanes; ++p) {
      code |= ((wd[p] >> bit) & 1u) << p;
    }
    out[c * step] = static_cast<uint8_t>(code);
  }
}

// Candidate b0 + t, in scratch slot t: decode, fill and walk; write its
// output row.
TRACE_HD void trace_one(const TraceArgs& a, int64_t b0, int64_t t) {
  const int64_t b = b0 + t;
  const int64_t pid = a.cand[b];
  const int64_t word0 = a.cand[a.B + b];
  const int64_t off = a.cand[2 * a.B + b];
  const int64_t wlen = a.cand[3 * a.B + b];
  const int64_t rel_end = a.cand[4 * a.B + b] - off;
  const int m = a.m;
  const int64_t C = a.chunk;
  const int64_t row = static_cast<int64_t>(a.w + 1) * C;
  const int32_t* boundary = a.tables;
  const int32_t* start_cost = a.tables + (m + 1);
  const int32_t* end_cost = a.tables + 2 * (m + 1);
  const uint8_t* pat = a.pcodes + pid * m;
  int32_t* E = a.E + t;
  uint8_t* codes = a.codes + t;

  // end overshoot: the walk starts at (m - over, min(rel_end, wlen))
  const int over = static_cast<int>(rel_end > wlen ? rel_end - wlen : 0);
  int i = static_cast<int>(rel_end - over);
  int j = m - over;
  trace_codes(a.planes, a.L, a.P, word0 * 32 + off, i, codes, C);

  for (int c = 0; c <= i; ++c) E[c * C] = c == 0 ? boundary[0] : -c;
  for (int r = 1; r <= j; ++r) {
    const uint32_t pc = pat[r - 1];
    const int32_t* prev = E + (r - 1) * row;
    int32_t* cur = E + r * row;
    int32_t run = boundary[r];
    cur[0] = run;
    int32_t left_up = prev[0];  // E[r - 1, c - 1]
    for (int c0 = 1; c0 <= i; c0 += kTraceAhead) {
      // the row above and the codes of kTraceAhead columns, loaded first
      int32_t up[kTraceAhead];
      uint32_t tc[kTraceAhead];
#pragma unroll
      for (int u = 0; u < kTraceAhead; ++u) {
        const int c = c0 + u;
        up[u] = c <= i ? prev[c * C] : 0;
        tc[u] = c <= i ? codes[(c - 1) * C] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kTraceAhead; ++u) {
        const int c = c0 + u;
        if (c <= i) {
          int32_t s = up[u] + 1;
          const int32_t d = left_up - (trace_match(a.eq, pc, tc[u]) ? 1 : 0);
          if (d < s) s = d;
          if (s < run) run = s;
          cur[c * C] = run;
          left_up = up[u];
        }
      }
    }
  }

  const int64_t stride_w = static_cast<int64_t>(a.w + 1) * C;
  int32_t g = E[j * stride_w + i * C] + i;
  const int32_t total = g + end_cost[over];
  int32_t* o = a.out + b * a.stride;
  int8_t* ops = reinterpret_cast<int8_t*>(o + kTraceFields);
  int n = 0;
  int pattern_start = 0;
  bool bad = false;
  while (j > 0) {
    if (a.alpha_on && i == 0) {
      // start overshoot: the pattern's first j chars hang off the text
      // start (trace.rs:322-335)
      pattern_start = j;
      g -= start_cost[j];
      break;
    }
    const int32_t* at = E + j * stride_w + i * C;
    const int32_t gi = g - i;  // D == g is E == g - i
    int op = -1;
    if (i > 0) {
      const int32_t diag = *(at - stride_w - C);
      if (diag == gi + 1 && trace_match(a.eq, pat[j - 1], codes[(i - 1) * C])) {
        op = kOpMatch;
      } else if (diag == gi) {
        op = kOpSub;
      } else if (*(at - C) == gi) {
        op = kOpDel;
      }
    }
    if (op < 0 && *(at - stride_w) == gi - 1) op = kOpIns;
    if (op < 0) {
      bad = true;
      break;
    }
    ops[n++] = static_cast<int8_t>(op);
    if (op != kOpMatch) --g;
    if (op != kOpDel) --j;
    if (op != kOpIns) --i;
  }
  const int64_t op_bytes = 4 * (a.stride - kTraceFields);
  for (int64_t s = n; s < op_bytes; ++s) ops[s] = -1;
  o[0] = i;
  o[1] = total;
  o[2] = pattern_start;
  o[3] = m - over;
  o[4] = (bad || g != 0) ? 1 : 0;
}

}  // namespace
