// The Myers'99 word scan of one tile for one pattern, with selection
// metadata: the body shared by the q1meta kernel (scan_meta.cu, one
// pattern) and the q2meta kernel (scan_q_meta.cu, Q patterns).
//
// One thread scans one tile: for each 32-position word of its window, the
// last pattern row's vertical delta words (vp, vm), its cost at the word
// start, and meta (bit 0: the word is owned and its exact minimum cost is
// <= k; bits 1-2: the decreasing-state code at the word start); per tile,
// `final`, the code after the last word.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
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

// Rows j0 .. j0 + rows - 1 (rows <= 32) of one word: the Myers step of
// reference bitpacking.rs:63-85 on 32 text positions. hpw/hmw carry the
// rows' horizontal deltas from the previous word (bit b = row j0 + b) and
// return those for the next; vp/vm flow down the rows.
template <int EQ>
__device__ __forceinline__ void scan_rows(
    const uint32_t (&x)[planes_of<EQ>()], const uint32_t* s_pm,
    const uint32_t* s_pad, const int32_t* s_pidx, int j0, int rows,
    uint32_t& hpw, uint32_t& hmw, uint32_t& vp, uint32_t& vm) {
  constexpr int P = planes_of<EQ>();
  constexpr int PM = masks_of<EQ>();
  uint32_t nhp = 0u;
  uint32_t nhm = 0u;
#pragma unroll 4
  for (int b = 0; b < rows; ++b) {
    const int j = j0 + b;
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
    const uint32_t hp_j = (hpw >> b) & 1u;
    const uint32_t hm_j = (hmw >> b) & 1u;
    const uint32_t vx = eq | vm;
    const uint32_t eqh = eq | hm_j;
    const uint32_t hx = (((eqh & vp) + vp) ^ vp) | eqh;
    const uint32_t hp_o = vm | ~(hx | vp);
    const uint32_t hm_o = vp & hx;
    nhp |= (hp_o >> 31) << b;
    nhm |= (hm_o >> 31) << b;
    const uint32_t hp_sh = (hp_o << 1) | hp_j;
    const uint32_t hm_sh = (hm_o << 1) | hm_j;
    vp = hm_sh | ~(vx | hp_sh);
    vm = hp_sh & vx;
  }
  hpw = nhp;
  hmw = nhm;
}

// One pattern over the tiles of one launch.
struct Args {
  const uint32_t* win;     // (NW, P, T) text plane words
  const uint8_t* tile0;    // (T,) bool: the tile owns the text start
  const int32_t* vfrom;    // (T,) window-local owned range (vfrom, vto]
  const int32_t* vto;      // (T,)
  const uint32_t* pmasks;  // (M, P) row masks; (M, P - 1) for ascii
  const uint32_t* is_pad;  // (M,) all-ones for pad rows
  const uint32_t* h_init;  // (M,) true-start h deltas, 0 or 1
  const int32_t* pidx;     // (M,) plane of each ACGT row (pure only)
  uint32_t* vp_out;        // (NW, T)
  uint32_t* vm_out;        // (NW, T)
  int32_t* cost_out;       // (NW, T)
  int32_t* meta_out;       // (NW, T)
  int32_t* final_out;      // (T,)
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
// then reads the same row in all threads at once (a broadcast).
template <int EQ, bool REG>
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
  const int vf = a.vfrom[t];
  const int vt = a.vto[t];
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
  for (int w = 0; w < a.NW; ++w) {
    uint32_t x[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      x[p] = a.win[(static_cast<size_t>(w) * P + p) * T + t];
    }
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
    const int pc_p = __popc(vp);
    const int pc_m = __popc(vm);
    int screen = 0;
    if (wvalid && cost - pc_m <= a.k) {
      int mp = word_min_prefix(vp, vm);
      if (owns_0) mp = min(mp, 0);
      screen = cost + mp <= a.k ? 1 : 0;
    }
    const size_t o = static_cast<size_t>(w) * T + t;
    a.vp_out[o] = vp;
    a.vm_out[o] = vm;
    a.cost_out[o] = cost;
    a.meta_out[o] = screen | (code << 1);
    cost += pc_p - pc_m;
    code = new_code;
  }
  a.final_out[t] = code;
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

// The planes of the windows that eq_mode takes, and for pure a plane
// index per row.
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

}  // namespace
