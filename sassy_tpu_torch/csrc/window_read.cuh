// The scan kernels' text read: each tile's window words straight from the
// packed planes, as __host__ __device__ code. myers_step.cuh's scan_block
// (q1meta, q2meta, q1, q2) runs it on the card, one thread a tile; a host
// build of this header (tests/torch_window_read_host.cc) runs it tile
// after tile and holds it to the plain gather (myers_torch.windows_plain).
//
// A tile's window is two numbers, not a copy of its words: window word i
// of tile t, plane p, is planes[p][wstart[t] + i] where
// 0 <= wstart[t] + i < min(wend[t], L), else 0. One rule for the single
// path's tiles (the head, halo tiles past the text start, the overhang
// tail tile), the batched engine's pieces (zero past their text) and a
// sharded slot's planes.
//
// The load pattern: the 32 lanes of a warp are 32 tiles whose windows lie
// W words apart, so a lane's load is a sector of its own, and its next
// words sit in that sector. The read keeps them in registers: a ring of
// two aligned groups of kGroupWords words a plane (the chunk's first group
// and the next), one 16-byte load a plane every 4 words through the
// read-only path, at the same word for every lane (the loop is uniform,
// no lane waits on another's load). A lane's start lies s = wstart mod 4
// words into its first group, so word u of a chunk of 4 is element s + u
// of the two groups, picked by two selects on the bits of s. The words
// outside [0, min(wend, L)) are masked to zero, and a group none of whose
// words is read is not loaded: the read never touches memory outside the
// planes.
//
// A ring of three groups a plane in the block's shared memory, filled by
// cp.async a chunk ahead, held ascii's nine planes in ~64 registers
// rather than 127-140, and was no faster (PERF.md, section 6).

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define WIN_HD __host__ __device__ __forceinline__
#else
#define WIN_HD inline
#endif

namespace {

// Words a plane one load brings (a 16-byte load), and what the planes
// must give it: rows of a multiple of 4 words, 16-byte aligned.
constexpr int kGroupWords = 4;
constexpr int kPlaneAlignWords = kGroupWords;

// Where each tile's window lies in the planes.
struct WindowDesc {
  const uint32_t* planes;  // (P, L) words, row-major, 16-byte aligned
  const int64_t* wstart;   // (T,) plane word of window word 0 (may be < 0)
  const int64_t* wend;     // (T,) exclusive end of the words it may read
  int64_t L;               // words a plane, a multiple of kPlaneAlignWords
};

// The 4 words of plane memory at p (16-byte aligned).
WIN_HD void load_group(const uint32_t* p, uint32_t (&g)[kGroupWords]) {
#if defined(__CUDA_ARCH__)
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  g[0] = v.x;
  g[1] = v.y;
  g[2] = v.z;
  g[3] = v.w;
#else
#ifdef SASSY_WINDOW_READ_HOOK
  SASSY_WINDOW_READ_HOOK(p, kGroupWords);  // a host build's load check
#endif
  for (int e = 0; e < kGroupWords; ++e) g[e] = p[e];
#endif
}

// A tile's place in the planes and its range.
struct WindowSpan {
  const uint32_t* planes;
  int64_t L;
  int64_t next;  // plane word of the next group to load (a multiple of 4)
  int at;        // window word of that group's first word
  int s;         // the window start's place in its group
  int lo, hi;    // window words [lo, hi) read the planes; the others are 0

  WIN_HD void start(const WindowDesc& d, int t, int NW) {
    planes = d.planes;
    L = d.L;
    const int64_t ws = d.wstart[t];
    const int64_t we = d.wend[t] < L ? d.wend[t] : L;
    const int64_t g0 = ws & ~static_cast<int64_t>(kGroupWords - 1);
    s = static_cast<int>(ws - g0);
    const int64_t lo64 = ws < 0 ? -ws : 0;
    const int64_t hi64 = we - ws;
    lo = static_cast<int>(lo64 < NW ? lo64 : NW);
    hi = static_cast<int>(hi64 < lo ? lo : (hi64 < NW ? hi64 : NW));
    next = g0;
    at = -s;
  }

  // Whether the group at `next` holds a word of [lo, hi): such an aligned
  // group lies inside the plane.
  WIN_HD bool group_read() const {
    return lo < hi && at < hi && at + kGroupWords > lo;
  }

  WIN_HD void step() {
    next += kGroupWords;
    at += kGroupWords;
  }

  // All ones where window word w is read from the planes, else 0.
  WIN_HD uint32_t keep(int w) const {
    return static_cast<unsigned>(w - lo) < static_cast<unsigned>(hi - lo)
               ? 0xFFFFFFFFu : 0u;
  }
};

template <int P>
struct WindowRing {
  WindowSpan span;
  uint32_t cur[P][kGroupWords];  // the group of the chunk's first word
  uint32_t nxt[P][kGroupWords];  // the group after it

  WIN_HD void start(const WindowDesc& d, int t, int NW) {
    span.start(d, t, NW);
    fetch(cur);
  }

  // The group at `next` into g (zeros where none of its words is read),
  // then step on by 4 words.
  WIN_HD void fetch(uint32_t (&g)[P][kGroupWords]) {
    const bool read = span.group_read();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (read) {
        load_group(span.planes + p * span.L + span.next, g[p]);
      } else {
#pragma unroll
        for (int e = 0; e < kGroupWords; ++e) g[p][e] = 0u;
      }
    }
    span.step();
  }

  // Window word w, the chunk's word u (u < 4, known at compile time):
  // element s + u of (cur, nxt), zero outside [lo, hi).
  WIN_HD void word(int u, int w, uint32_t (&x)[P]) const {
    const uint32_t keep = span.keep(w);
    const int s = span.s;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      uint32_t c[kGroupWords];
#pragma unroll
      for (int e = 0; e < kGroupWords; ++e) {
        c[e] = u + e < kGroupWords ? cur[p][u + e]
                                   : nxt[p][u + e - kGroupWords];
      }
      // a tree of two selects on the bits of s: candidate s
      const uint32_t a = (s & 1) ? c[1] : c[0];
      const uint32_t b = (s & 1) ? c[3] : c[2];
      x[p] = ((s & 2) ? b : a) & keep;
    }
  }

  WIN_HD void advance() {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int e = 0; e < kGroupWords; ++e) cur[p][e] = nxt[p][e];
    }
  }
};

// f(w, x) for the NW window words of tile t in order, x[p] the word of
// plane p: a chunk of 4 words a step, their calls unrolled.
template <int P, typename F>
WIN_HD void for_each_window_word(const WindowDesc& d, int t, int NW, F&& f) {
  WindowRing<P> ring;
  ring.start(d, t, NW);
  for (int w0 = 0; w0 < NW; w0 += kGroupWords) {
    ring.fetch(ring.nxt);
#pragma unroll
    for (int u = 0; u < kGroupWords; ++u) {
      if (w0 + u < NW) {
        uint32_t x[P];
        ring.word(u, w0 + u, x);
        f(w0 + u, x);
      }
    }
    ring.advance();
  }
}

}  // namespace
