// The Myers'99 word scan of one tile for one pattern: the body shared by
// the scan kernels, q1meta (scan_meta.cu, one pattern) and q2meta
// (scan_q_meta.cu, Q patterns) with selection metadata, q1 (scan.cu) and
// q2 (scan_q.cu) without; the row step also by the kernel-design family
// (scan_qn.cu) and the row-step ablations (scan_variants.cu).
//
// One thread scans one tile: for each 32-position word of its window, the
// last pattern row's vertical delta words (vp, vm) and its cost at the word
// start; with META also meta (bit 0: the word is owned and its exact
// minimum cost is <= k; bits 1-2: the decreasing-state code at the word
// start) and, per tile, `final`, the code after the last word. The window
// is read straight from the packed planes (window_read.cuh): a tile is
// two numbers, wstart and wend, not a copy of its words.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "myers_word.cuh"  // myers_step, the row step
#include "window_read.cuh"

namespace {

constexpr int kThreads = 256;

// Blocks of the four search-path scan kernels an SM must hold at once, the
// second argument of their __launch_bounds__. At 1 the compiler gives the
// ascii eq's register ring 127-140 registers; the one-argument form capped
// it at 128 and cost it 13-15%, 2 the same, 3 (85 registers and spills)
// 60%; 4 made no other kernel faster.
constexpr int kScanMinBlocks = 1;
constexpr int kEqIupac = 0;  // eq = pad | OR_p (plane_p & mask_p)
constexpr int kEqPure = 1;   // eq = pad | the row's one plane (ACGT rows)
constexpr int kEqAscii = 2;  // eq = pad | (valid & ~OR_p (plane_p ^ mask_p))
constexpr int kRegRows = 64;

template <int EQ>
__host__ __device__ constexpr int planes_of() {
  return EQ == kEqAscii ? 9 : 4;
}

// Mask columns per pattern row: ascii's validity plane has none.
template <int EQ>
__host__ __device__ constexpr int masks_of() {
  return EQ == kEqAscii ? planes_of<EQ>() - 1 : planes_of<EQ>();
}

// Exact min over i = 1..32 of the prefix sums of the word's deltas
// (vp bit = +1, vm bit = -1).
__device__ __forceinline__ int word_min_prefix(uint32_t vp, uint32_t vm) {
  int s = 0;
  int mn = 32;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s += static_cast<int>((vp >> i) & 1u) - static_cast<int>((vm >> i) & 1u);
    mn = min(mn, s);
  }
  return mn;
}

// Keeps delta bit j of the word starting at window position w32 iff its
// position w32 + j + 1 lies in the owned range (vf, vt]. Both shifts are
// guarded: a shift by 32 is undefined.
__device__ __forceinline__ uint32_t owned_mask(int w32, int vf, int vt) {
  const int lo = min(max(vf - w32, 0), 32);
  const int hi = min(max(vt - w32, 0), 32);
  const uint32_t m_lo = lo >= 32 ? 0u : (0xFFFFFFFFu << lo);
  const uint32_t m_hi = hi >= 32 ? 0xFFFFFFFFu : ~(0xFFFFFFFFu << hi);
  return m_lo & m_hi;
}

// eq of pattern row j against the 32 text positions of one word.
template <int EQ>
__device__ __forceinline__ uint32_t row_eq(
    const uint32_t (&x)[planes_of<EQ>()], const uint32_t* s_pm,
    const uint32_t* s_pad, const int32_t* s_pidx, int j) {
  constexpr int P = planes_of<EQ>();
  constexpr int PM = masks_of<EQ>();
  uint32_t eq = s_pad[j];  // pad rows match everything
  if (EQ == kEqPure) {
    const int pi = s_pidx[j];
    eq |= pi == 0 ? x[0] : pi == 1 ? x[1] : pi == 2 ? x[2] : x[3];
  } else if (EQ == kEqIupac) {
#pragma unroll
    for (int p = 0; p < P; ++p) eq |= x[p] & s_pm[j * PM + p];
  } else {
    uint32_t acc = 0u;
#pragma unroll
    for (int p = 0; p < PM; ++p) acc |= x[p] ^ s_pm[j * PM + p];
    eq |= ~acc & x[P - 1];
  }
  return eq;
}

// Row j of one word with bit-packed carries: bit b of hpw/hmw holds the
// row's horizontal deltas from the previous word, bit b of nhp/nhm gets
// those for the next.
template <int EQ>
__device__ __forceinline__ void row_step(
    const uint32_t (&x)[planes_of<EQ>()], const uint32_t* s_pm,
    const uint32_t* s_pad, const int32_t* s_pidx, int j, int b, uint32_t hpw,
    uint32_t hmw, uint32_t& nhp, uint32_t& nhm, uint32_t& vp, uint32_t& vm) {
  const uint32_t eq = row_eq<EQ>(x, s_pm, s_pad, s_pidx, j);
  uint32_t hp_o, hm_o;
  myers_step(eq, (hpw >> b) & 1u, (hmw >> b) & 1u, vp, vm, hp_o, hm_o);
  nhp |= (hp_o >> 31) << b;
  nhm |= (hm_o >> 31) << b;
}

// Rows j0 .. j0 + rows - 1 (rows <= 32) of one word. hpw/hmw carry the
// rows' horizontal deltas from the previous word (bit b = row j0 + b) and
// return those for the next; vp/vm flow down the rows.
template <int EQ>
__device__ __forceinline__ void scan_rows(
    const uint32_t (&x)[planes_of<EQ>()], const uint32_t* s_pm,
    const uint32_t* s_pad, const int32_t* s_pidx, int j0, int rows,
    uint32_t& hpw, uint32_t& hmw, uint32_t& vp, uint32_t& vm) {
  uint32_t nhp = 0u;
  uint32_t nhm = 0u;
#pragma unroll 4
  for (int b = 0; b < rows; ++b) {
    row_step<EQ>(x, s_pm, s_pad, s_pidx, j0 + b, b, hpw, hmw, nhp, nhm, vp,
                 vm);
  }
  hpw = nhp;
  hmw = nhm;
}

// One pattern over the tiles of one launch.
struct Args {
  const uint32_t* planes;  // (P, L) text plane words (WindowDesc)
  const int64_t* wstart;   // (T,) plane word of each tile's window word 0
  const int64_t* wend;     // (T,) exclusive end of the words it may read
  int64_t L;               // words a plane
  const uint32_t* win;     // (NW, P, T) window words: scan_qn.cu only
  const uint8_t* tile0;    // (T,) bool: the tile owns the text start
  const int32_t* vfrom;    // (T,) window-local owned range (vfrom, vto];
  const int32_t* vto;      // (T,) META only
  const uint32_t* pmasks;  // (M, P) row masks; (M, P - 1) for ascii
  const uint32_t* is_pad;  // (M,) all-ones for pad rows
  const uint32_t* h_init;  // (M,) true-start h deltas, 0 or 1
  const int32_t* pidx;     // (M,) plane of each ACGT row (pure only)
  uint32_t* vp_out;        // (NW, T)
  uint32_t* vm_out;        // (NW, T)
  int32_t* cost_out;       // (NW, T)
  int32_t* meta_out;       // (NW, T), META only
  int32_t* final_out;      // (T,), META only
  uint32_t* carries;       // (2 * ceil(M / 32), T), for M > kRegRows only
  int T, NW, M, m_real, boundary_m, k;
};

// Dynamic shared memory of a block: the pattern's row masks, pad flags and
// pure plane indices.
template <int EQ>
size_t smem_bytes(int M) {
  return static_cast<size_t>(M) * (masks_of<EQ>() + 2) * 4;
}

// The tiles block * kThreads + threadIdx.x of one pattern. Every thread of
// the block first stages the pattern's rows in shared memory: the row loop
// then reads the same row in all threads at once (a broadcast). META adds
// the selection metadata; without it vfrom, vto, k, meta and final are
// not touched.
template <int EQ, bool REG, bool META>
__device__ __forceinline__ void scan_block(const Args& a, int block) {
  constexpr int P = planes_of<EQ>();
  constexpr int PM = masks_of<EQ>();
  extern __shared__ uint32_t smem[];
  const int M = a.M;
  uint32_t* s_pm = smem;
  uint32_t* s_pad = s_pm + M * PM;
  int32_t* s_pidx = reinterpret_cast<int32_t*>(s_pad + M);
  for (int i = threadIdx.x; i < M * PM; i += kThreads) s_pm[i] = a.pmasks[i];
  for (int i = threadIdx.x; i < M; i += kThreads) {
    s_pad[i] = a.is_pad[i];
    s_pidx[i] = EQ == kEqPure ? a.pidx[i] : 0;
  }
  __syncthreads();

  const int t = block * kThreads + threadIdx.x;
  if (t >= a.T) return;
  const size_t T = static_cast<size_t>(a.T);
  const bool lane0 = a.tile0[t] != 0;
  const int vf = META ? a.vfrom[t] : 0;
  const int vt = META ? a.vto[t] : 0;
  const int NC = (M + 31) >> 5;

  // initial carries: pad rows 0, the true start h_init, other tiles +1
  uint32_t hp_r0 = 0u, hp_r1 = 0u, hm_r0 = 0u, hm_r1 = 0u;
  for (int c = 0; c < NC; ++c) {
    uint32_t hpw = 0u;
    const int rows = min(32, M - 32 * c);
    for (int b = 0; b < rows; ++b) {
      const int j = 32 * c + b;
      const uint32_t h = s_pad[j] ? 0u : (lane0 ? (a.h_init[j] & 1u) : 1u);
      hpw |= h << b;
    }
    if (REG) {
      if (c == 0) hp_r0 = hpw;
      else hp_r1 = hpw;
    } else {
      a.carries[static_cast<size_t>(c) * T + t] = hpw;
      a.carries[static_cast<size_t>(NC + c) * T + t] = 0u;
    }
  }

  int cost = lane0 ? a.boundary_m : a.m_real;
  int code = 0;
  const WindowDesc d = {a.planes, a.wstart, a.wend, a.L};
  for_each_window_word<P>(d, t, a.NW, [&](int w, const uint32_t (&x)[P]) {
    uint32_t vp = 0u;
    uint32_t vm = 0u;
    if (REG) {
      scan_rows<EQ>(x, s_pm, s_pad, s_pidx, 0, min(32, M), hp_r0, hm_r0, vp,
                    vm);
      if (M > 32) {
        scan_rows<EQ>(x, s_pm, s_pad, s_pidx, 32, M - 32, hp_r1, hm_r1, vp,
                      vm);
      }
    } else {
      for (int c = 0; c < NC; ++c) {
        uint32_t* hp_c = a.carries + static_cast<size_t>(c) * T + t;
        uint32_t* hm_c = a.carries + static_cast<size_t>(NC + c) * T + t;
        uint32_t hpw = *hp_c;
        uint32_t hmw = *hm_c;
        scan_rows<EQ>(x, s_pm, s_pad, s_pidx, 32 * c, min(32, M - 32 * c),
                      hpw, hmw, vp, vm);
        *hp_c = hpw;
        *hm_c = hmw;
      }
    }

    const size_t o = static_cast<size_t>(w) * T + t;
    const int pc_p = __popc(vp);
    const int pc_m = __popc(vm);
    a.vp_out[o] = vp;
    a.vm_out[o] = vm;
    a.cost_out[o] = cost;
    if (META) {
      const int w32 = 32 * w;
      // state code: sign of the last owned delta (vp and vm are disjoint,
      // so the larger word holds the higher bit), carried across words
      const uint32_t om = owned_mask(w32, vf, vt);
      const uint32_t vp_o = vp & om;
      const uint32_t vm_o = vm & om;
      const int new_code = (vp_o | vm_o) ? (2 | (vp_o > vm_o ? 1 : 0)) : code;
      // screen: word 0 of a tile owning position 0 also stands for the
      // boundary candidate (position 0, cost = the word-start cost)
      const bool owns_0 = w == 0 && vf < 0;
      const bool wvalid = w32 + 32 > vf && (w32 + 1 <= vt || owns_0);
      int screen = 0;
      if (wvalid && cost - pc_m <= a.k) {
        int mp = word_min_prefix(vp, vm);
        if (owns_0) mp = min(mp, 0);
        screen = cost + mp <= a.k ? 1 : 0;
      }
      a.meta_out[o] = screen | (code << 1);
      code = new_code;
    }
    cost += pc_p - pc_m;
  });
  if (META) a.final_out[t] = code;
}

// Q patterns over the same windows: `base` holds the shared planes, window
// descriptors and tile vectors, and the pointers of pattern 0.
struct QArgs {
  Args base;
  const int32_t* m_real;      // (Q,) unpadded pattern lengths
  const int32_t* boundary_m;  // (Q,) cost at the text start, row m
  int Q;
};

// Block b of a Q-pattern grid scans pattern b % Q over the tiles of block
// b / Q: the Q blocks of one tile range run next to each other, so a
// plane word comes from device memory once and from L2 for the other
// Q - 1 patterns. The pointers of pattern 0 are offset to pattern q's.
template <int EQ, bool REG, bool META>
__device__ __forceinline__ void scan_q_block(const QArgs& qa) {
  const int q = static_cast<int>(blockIdx.x % static_cast<unsigned>(qa.Q));
  const int block = static_cast<int>(blockIdx.x / static_cast<unsigned>(qa.Q));
  Args a = qa.base;
  const size_t M = static_cast<size_t>(a.M);
  const size_t T = static_cast<size_t>(a.T);
  const size_t rows = static_cast<size_t>(q) * M;
  const size_t words = static_cast<size_t>(q) * a.NW * T;
  a.pmasks += rows * masks_of<EQ>();
  a.is_pad += rows;
  a.h_init += rows;
  if (EQ == kEqPure) a.pidx += rows;
  a.vp_out += words;
  a.vm_out += words;
  a.cost_out += words;
  if (META) {
    a.meta_out += words;
    a.final_out += static_cast<size_t>(q) * T;
  }
  if (!REG) a.carries += static_cast<size_t>(q) * 2 * ((M + 31) / 32) * T;
  a.m_real = qa.m_real[q];
  a.boundary_m = qa.boundary_m[q];
  scan_block<EQ, REG, META>(a, block);
}

// Blocks of a Q-pattern grid over T tiles; 0 when the grid is too large.
inline unsigned q_blocks(int T, int Q) {
  const long long tile_blocks =
      (static_cast<long long>(T) + kThreads - 1) / kThreads;
  const long long blocks = tile_blocks * Q;
  return blocks > 0x7FFFFFFF ? 0u : static_cast<unsigned>(blocks);
}

// Launches `kernel` on `stream` with the dynamic shared memory it asks
// for (above 48 KB only once the kernel is allowed it); returns the
// launch's error.
template <typename Kernel, typename A>
cudaError_t launch_blocks(Kernel kernel, const A& a, size_t smem,
                          unsigned blocks, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The planes that eq_mode takes, and for pure a plane index per row.
inline bool eq_inputs_ok(int eq_mode, int P, const void* pidx) {
  switch (eq_mode) {
    case kEqIupac:
      return P == planes_of<kEqIupac>();
    case kEqPure:
      return P == planes_of<kEqPure>() && pidx != nullptr;
    case kEqAscii:
      return P == planes_of<kEqAscii>();
    default:
      return false;
  }
}

// What the window read takes (window_read.cuh): planes, descriptors, and
// rows of a multiple of kPlaneAlignWords words, 16-byte aligned.
inline bool window_inputs_ok(const void* planes, const void* wstart,
                             const void* wend, long long L) {
  return planes != nullptr && wstart != nullptr && wend != nullptr && L > 0 &&
         L % kPlaneAlignWords == 0 &&
         reinterpret_cast<uintptr_t>(planes) % (4 * kPlaneAlignWords) == 0;
}

// Sets the shared planes and window descriptors of a launch.
inline void set_windows(Args& a, const void* planes, const void* wstart,
                        const void* wend, long long L) {
  a.planes = static_cast<const uint32_t*>(planes);
  a.wstart = static_cast<const int64_t*>(wstart);
  a.wend = static_cast<const int64_t*>(wend);
  a.L = L;
}

}  // namespace
