// Single-pattern Myers'99 word scan with selection metadata, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel get_pallas_scan_meta ("q1meta") of
// sassy_tpu/ops/myers_pallas.py. It computes what that kernel computes:
// for each tile of halo-tiled text and each 32-position word of its window,
// the last pattern row's vertical delta words (vp, vm), its cost at the
// word start, and meta (bit 0: the word is owned and its exact minimum
// cost is <= k; bits 1-2: the decreasing-state code at the word start);
// per tile, `final`, the code after the last word.
//
// What bounds it on the H100: integer issue. Per window word a thread
// reads P plane words and writes four output words (32 bytes for P = 4),
// and runs about 20 integer operations for each of the M pattern rows
// (~500 at M = 24), some 15 operations per byte moved, where the card's
// ~15 Tops/s of int32 against 3.35 TB/s break even at ~4.5.
//
// What the design does about it:
// - one thread per tile (the plan in sassy_tpu_torch/ops/plan.py puts
//   ~0.5M tiles in flight for a 1 GiB text), the text window in the
//   (NW, P, T) layout, so a warp's loads and stores of one word are 32
//   adjacent tiles: every byte crosses the memory bus once;
// - the per-row horizontal carries hp/hm stay bit-packed in registers,
//   bit j = row j, for M <= 64 (two words each); longer patterns keep them
//   per thread in device memory laid out [word][tile], so those accesses
//   coalesce too, and cost 4 accesses per 32 rows;
// - the pattern rows' masks sit in shared memory: every thread of a block
//   reads the same row at once (a broadcast);
// - native uint32 arithmetic, __popc for the cost chain, and the exact
//   32-step min-prefix of a word only where cost - popc(vm), a lower
//   bound of the word's minimum, reaches k (rarely, on random text).
//
// Built by sassy_tpu_torch/ops/myers_cuda.py with nvcc into a shared
// library with a plain C entry point, loaded with ctypes.

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

template <int EQ, bool REG>
__global__ void __launch_bounds__(kThreads) scan_meta_kernel(const Args a) {
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

  const int t = blockIdx.x * kThreads + threadIdx.x;
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

template <int EQ, bool REG>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.M) * (masks_of<EQ>() + 2) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_meta_kernel<EQ, REG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const unsigned blocks = static_cast<unsigned>((a.T + kThreads - 1) / kThreads);
  scan_meta_kernel<EQ, REG><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int EQ>
cudaError_t launch_eq(const Args& a, cudaStream_t stream) {
  return a.M <= kRegRows ? launch<EQ, true>(a, stream)
                         : launch<EQ, false>(a, stream);
}

}  // namespace

// Launches the scan on `stream` without synchronising; returns the
// cudaError_t of the launch (0 = success).
extern "C" int sassy_scan_meta(
    const void* win, const void* tile0, const void* vfrom, const void* vto,
    const void* pmasks, const void* is_pad, const void* h_init,
    const void* pidx, void* vp_out, void* vm_out, void* cost_out,
    void* meta_out, void* final_out, void* carries, int T, int NW, int P,
    int M, int m_real, int boundary_m, int k, int eq_mode, void* stream) {
  Args a;
  a.win = static_cast<const uint32_t*>(win);
  a.tile0 = static_cast<const uint8_t*>(tile0);
  a.vfrom = static_cast<const int32_t*>(vfrom);
  a.vto = static_cast<const int32_t*>(vto);
  a.pmasks = static_cast<const uint32_t*>(pmasks);
  a.is_pad = static_cast<const uint32_t*>(is_pad);
  a.h_init = static_cast<const uint32_t*>(h_init);
  a.pidx = static_cast<const int32_t*>(pidx);
  a.vp_out = static_cast<uint32_t*>(vp_out);
  a.vm_out = static_cast<uint32_t*>(vm_out);
  a.cost_out = static_cast<int32_t*>(cost_out);
  a.meta_out = static_cast<int32_t*>(meta_out);
  a.final_out = static_cast<int32_t*>(final_out);
  a.carries = static_cast<uint32_t*>(carries);
  a.T = T;
  a.NW = NW;
  a.M = M;
  a.m_real = m_real;
  a.boundary_m = boundary_m;
  a.k = k;
  if (T <= 0 || NW <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((M > kRegRows) != (carries != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (eq_mode) {
    case kEqIupac:
      if (P != planes_of<kEqIupac>()) break;
      return static_cast<int>(launch_eq<kEqIupac>(a, s));
    case kEqPure:
      if (P != planes_of<kEqPure>() || pidx == nullptr) break;
      return static_cast<int>(launch_eq<kEqPure>(a, s));
    case kEqAscii:
      if (P != planes_of<kEqAscii>()) break;
      return static_cast<int>(launch_eq<kEqAscii>(a, s));
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
