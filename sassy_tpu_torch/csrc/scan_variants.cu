// Ablations of the Myers'99 row step, for Hopper (sm_90a): where the time
// of the scan's inner loop goes.
//
// Replaces the TPU kernel make(variant) of scripts/kernel_variants.py. It
// computes what that kernel computes: one pattern of M rows (no pad rows)
// over (NW, 4, T) windows with the iupac eq, every tile from the plain
// boundary (all row carries hp = 1, hm = 0, no text-start tile), and only
// the last row's vp word per window word, in one of four variants whose
// (partly meaningless) arithmetic is fixed so that each has a plain
// version to be held against:
//
//   full     the row step as the scan kernels run it;
//   noeq     eq is plane 0's word: no mask loads, no AND/OR over planes;
//   nomem    the row's incoming h deltas are taken from vp and vm and no
//            carry is kept: the same operations without the carry words;
//   nostore  no vp stores: a thread adds up the popcounts of its vp words
//            and writes the sum once, to row 0 of a (1, T) output.
//
// `python -m sassy_tpu_torch.tools.kernel_variants` times them against
// each other; no search path launches them. `full`'s vp equals scan.cu's
// for the same pattern with h_init = 1 and no text-start tile.
//
// What bounds them on the H100: integer issue (full: the row loop of
// q1). On the TPU the row carries lived in VMEM scratch, which `nomem`
// removed; here they are bit-packed in two registers per sign (M <= 64),
// so `nomem` removes four shifts and two ORs per row, not memory traffic.

#include "myers_step.cuh"

namespace {

constexpr int kFull = 0;
constexpr int kNoEq = 1;
constexpr int kNoMem = 2;
constexpr int kNoStore = 3;
constexpr int kP = 4;  // iupac planes

struct VArgs {
  const uint32_t* win;     // (NW, 4, T)
  const uint32_t* pmasks;  // (M, 4)
  uint32_t* out;           // (NW, T); nostore: (1, T)
  int T, NW, M;
};

// Rows j0 .. j0 + rows - 1 (<= 32) of one word, as scan_rows runs them.
template <int V>
__device__ __forceinline__ void variant_rows(
    const uint32_t (&x)[kP], const uint32_t* s_pm, int j0, int rows,
    uint32_t& hpw, uint32_t& hmw, uint32_t& vp, uint32_t& vm) {
  uint32_t nhp = 0u;
  uint32_t nhm = 0u;
#pragma unroll 4
  for (int b = 0; b < rows; ++b) {
    const int j = j0 + b;
    uint32_t eq = 0u;
    if (V == kNoEq) {
      eq = x[0];
    } else {
#pragma unroll
      for (int p = 0; p < kP; ++p) eq |= x[p] & s_pm[j * kP + p];
    }
    const uint32_t hp_j = V == kNoMem ? vp : (hpw >> b) & 1u;
    const uint32_t hm_j = V == kNoMem ? vm : (hmw >> b) & 1u;
    uint32_t hp_o, hm_o;
    myers_step(eq, hp_j, hm_j, vp, vm, hp_o, hm_o);
    if (V != kNoMem) {
      nhp |= (hp_o >> 31) << b;
      nhm |= (hm_o >> 31) << b;
    }
  }
  if (V != kNoMem) {
    hpw = nhp;
    hmw = nhm;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads) scan_variant_kernel(
    const VArgs a) {
  extern __shared__ uint32_t smem[];
  const int M = a.M;
  for (int i = threadIdx.x; i < M * kP; i += kThreads) smem[i] = a.pmasks[i];
  __syncthreads();

  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.T) return;
  const size_t T = static_cast<size_t>(a.T);
  // every row starts with hp = 1, hm = 0
  uint32_t hp0 = M >= 32 ? 0xFFFFFFFFu : ((1u << M) - 1u);
  uint32_t hp1 = M > 32 ? (M >= 64 ? 0xFFFFFFFFu : ((1u << (M - 32)) - 1u))
                        : 0u;
  uint32_t hm0 = 0u, hm1 = 0u;
  int acc = 0;
  for (int w = 0; w < a.NW; ++w) {
    uint32_t x[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      x[p] = a.win[(static_cast<size_t>(w) * kP + p) * T + t];
    }
    uint32_t vp = 0u;
    uint32_t vm = 0u;
    variant_rows<V>(x, smem, 0, min(32, M), hp0, hm0, vp, vm);
    if (M > 32) variant_rows<V>(x, smem, 32, M - 32, hp1, hm1, vp, vm);
    if (V != kNoStore) a.out[static_cast<size_t>(w) * T + t] = vp;
    acc += __popc(vp);
  }
  if (V == kNoStore) a.out[t] = static_cast<uint32_t>(acc);
}

template <int V>
cudaError_t launch_variant(const VArgs& a, unsigned blocks,
                           cudaStream_t stream) {
  return launch_blocks(scan_variant_kernel<V>, a,
                       static_cast<size_t>(a.M) * kP * 4, blocks, stream);
}

}  // namespace

// Launches variant 0..3 (full, noeq, nomem, nostore) on `stream` without
// synchronising; returns the cudaError_t of the launch (0 = success).
extern "C" int sassy_scan_variant(const void* win, const void* pmasks,
                                  void* out, int T, int NW, int P, int M,
                                  int variant, void* stream) {
  VArgs a = {};
  a.win = static_cast<const uint32_t*>(win);
  a.pmasks = static_cast<const uint32_t*>(pmasks);
  a.out = static_cast<uint32_t*>(out);
  a.T = T;
  a.NW = NW;
  a.M = M;
  if (T <= 0 || NW <= 0 || M <= 0 || M > kRegRows || P != kP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned nb = q_blocks(T, 1);
  if (nb == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull:
      return static_cast<int>(launch_variant<kFull>(a, nb, s));
    case kNoEq:
      return static_cast<int>(launch_variant<kNoEq>(a, nb, s));
    case kNoMem:
      return static_cast<int>(launch_variant<kNoMem>(a, nb, s));
    case kNoStore:
      return static_cast<int>(launch_variant<kNoStore>(a, nb, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
