// The kernel-design family of the pattern-batched Myers'99 word scan, for
// Hopper (sm_90a): the q2 scan (scan_q.cu: vp, vm and cost of Q patterns
// over shared windows, (Q, NW, T) each) with three design parameters,
//
//   U   patterns per thread: a thread scans its tile for U patterns, loads
//       each window word's planes once and runs the U row chains
//       interleaved, row by row (independent chains for the scheduler);
//   MU  0: the row loop stays a loop (`#pragma unroll 1`) over the M rows
//       given at run time; > 0: M is MU at compile time and the rows are
//       fully unrolled, so every carry bit has a constant position;
//   WU  window words per iteration of the word loop: the planes of WU
//       words are loaded before their row chains run.
//
// Replaces four TPU kernels. U = 1, MU = 0, WU = 1 is the counterpart of
// get_pallas_scan_q (sassy_tpu/ops/myers_pallas.py, one pattern per
// program; iupac, pure and ascii eq). The iupac family replaces the three
// of scripts/kernel_qn.py: make_call (U patterns per program),
// make_call_unroll (rows unrolled) and make_call_unroll_w (WU words per
// iteration). They exist to be measured against each other and against
// scan_q.cu by `python -m sassy_tpu_torch.tools.kernel_qn`; no search
// path launches them.
//
// What bounds them on the H100: integer issue, as q2. The windows come
// from L2 for all but the first pattern group of a tile range, once per U
// patterns. Row carries are bit-packed in registers, two words per
// pattern and sign, so M <= 64. Registers grow with U (carries, vp, vm
// and cost per pattern) and with WU (P plane words each).

#include "myers_step.cuh"

namespace {

// Rows j0 .. j0 + rows - 1 (<= 32) of one word for U patterns, the U
// chains interleaved row by row. ROWS > 0: that many rows, unrolled; 0:
// `rows` at run time, one row per iteration. Pattern u's masks lie
// u * M rows after pattern 0's.
template <int EQ, int U, int ROWS>
__device__ __forceinline__ void scan_rows_u(
    const uint32_t (&x)[planes_of<EQ>()], const uint32_t* s_pm,
    const uint32_t* s_pad, const int32_t* s_pidx, int M, int j0, int rows,
    uint32_t (&hpw)[U], uint32_t (&hmw)[U], uint32_t (&vp)[U],
    uint32_t (&vm)[U]) {
  constexpr int PM = masks_of<EQ>();
  uint32_t nhp[U];
  uint32_t nhm[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    nhp[u] = 0u;
    nhm[u] = 0u;
  }
  if (ROWS > 0) {
#pragma unroll
    for (int b = 0; b < ROWS; ++b) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        row_step<EQ>(x, s_pm + u * M * PM, s_pad + u * M, s_pidx + u * M,
                     j0 + b, b, hpw[u], hmw[u], nhp[u], nhm[u], vp[u], vm[u]);
      }
    }
  } else {
#pragma unroll 1
    for (int b = 0; b < rows; ++b) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        row_step<EQ>(x, s_pm + u * M * PM, s_pad + u * M, s_pidx + u * M,
                     j0 + b, b, hpw[u], hmw[u], nhp[u], nhm[u], vp[u], vm[u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    hpw[u] = nhp[u];
    hmw[u] = nhm[u];
  }
}

// Block b scans patterns (b % (Q / U)) * U .. + U over the tiles of block
// b / (Q / U): the pattern groups of one tile range run next to each
// other, as scan_q_block's patterns do.
template <int EQ, int U, int MU, int WU>
__global__ void __launch_bounds__(kThreads) scan_qn_kernel(const QArgs qa) {
  constexpr int P = planes_of<EQ>();
  constexpr int PM = masks_of<EQ>();
  constexpr int R0 = MU > 32 ? 32 : MU;  // unrolled rows of carry word 0
  constexpr int R1 = MU > 32 ? MU - 32 : 0;  // and of carry word 1
  constexpr int R1S = R1 > 0 ? R1 : 1;  // a row count to instantiate
  extern __shared__ uint32_t smem[];
  const Args& a = qa.base;
  const int M = MU > 0 ? MU : a.M;
  const unsigned groups = static_cast<unsigned>(qa.Q / U);
  const int q0 = static_cast<int>(blockIdx.x % groups) * U;
  const int block = static_cast<int>(blockIdx.x / groups);

  // the U patterns' rows are contiguous in the (Q, M, .) inputs
  uint32_t* s_pm = smem;
  uint32_t* s_pad = s_pm + U * M * PM;
  int32_t* s_pidx = reinterpret_cast<int32_t*>(s_pad + U * M);
  const size_t row0 = static_cast<size_t>(q0) * M;
  for (int i = threadIdx.x; i < U * M * PM; i += kThreads) {
    s_pm[i] = a.pmasks[row0 * PM + i];
  }
  for (int i = threadIdx.x; i < U * M; i += kThreads) {
    s_pad[i] = a.is_pad[row0 + i];
    s_pidx[i] = EQ == kEqPure ? a.pidx[row0 + i] : 0;
  }
  __syncthreads();

  const int t = block * kThreads + threadIdx.x;
  if (t >= a.T) return;
  const size_t T = static_cast<size_t>(a.T);
  const bool lane0 = a.tile0[t] != 0;

  // initial carries: pad rows 0, the true start h_init, other tiles +1
  uint32_t hp0[U], hp1[U], hm0[U], hm1[U];
  int cost[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    uint32_t lo = 0u, hi = 0u;
    for (int j = 0; j < M; ++j) {
      const uint32_t h =
          s_pad[u * M + j] ? 0u : (lane0 ? (a.h_init[row0 + u * M + j] & 1u)
                                         : 1u);
      if (j < 32) lo |= h << j;
      else hi |= h << (j - 32);
    }
    hp0[u] = lo;
    hp1[u] = hi;
    hm0[u] = 0u;
    hm1[u] = 0u;
    cost[u] = lane0 ? qa.boundary_m[q0 + u] : qa.m_real[q0 + u];
  }

  for (int wb = 0; wb < a.NW; wb += WU) {
    uint32_t x[WU][P];
#pragma unroll
    for (int dw = 0; dw < WU; ++dw) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        x[dw][p] = a.win[(static_cast<size_t>(wb + dw) * P + p) * T + t];
      }
    }
#pragma unroll
    for (int dw = 0; dw < WU; ++dw) {
      uint32_t vp[U], vm[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        vp[u] = 0u;
        vm[u] = 0u;
      }
      if (MU > 0) {
        scan_rows_u<EQ, U, R0>(x[dw], s_pm, s_pad, s_pidx, M, 0, R0, hp0, hm0,
                               vp, vm);
        if (R1 > 0) {
          scan_rows_u<EQ, U, R1S>(x[dw], s_pm, s_pad, s_pidx, M, 32, R1, hp1,
                                  hm1, vp, vm);
        }
      } else {
        scan_rows_u<EQ, U, 0>(x[dw], s_pm, s_pad, s_pidx, M, 0, min(32, M),
                              hp0, hm0, vp, vm);
        if (M > 32) {
          scan_rows_u<EQ, U, 0>(x[dw], s_pm, s_pad, s_pidx, M, 32, M - 32,
                                hp1, hm1, vp, vm);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t o =
            (static_cast<size_t>(q0 + u) * a.NW + (wb + dw)) * T + t;
        a.vp_out[o] = vp[u];
        a.vm_out[o] = vm[u];
        a.cost_out[o] = cost[u];
        cost[u] += __popc(vp[u]) - __popc(vm[u]);
      }
    }
  }
}

template <int EQ, int U, int MU, int WU>
cudaError_t launch_qn(const QArgs& qa, cudaStream_t stream) {
  const unsigned nb = q_blocks(qa.base.T, qa.Q / U);
  if (nb == 0) return cudaErrorInvalidValue;
  return launch_blocks(scan_qn_kernel<EQ, U, MU, WU>, qa,
                       U * smem_bytes<EQ>(qa.base.M), nb, stream);
}

}  // namespace

// The members of the family that are built: (eq, U, unrolled rows or 0,
// WU). ops/myers_cuda.py lists the same ones (QN_LOOP_U, QN_UNROLL,
// QN_UNROLL_ROWS).
#define SASSY_QN_MEMBERS(X)                                          \
  X(kEqIupac, 1, 0, 1) X(kEqPure, 1, 0, 1) X(kEqAscii, 1, 0, 1)      \
  X(kEqIupac, 2, 0, 1) X(kEqIupac, 4, 0, 1) X(kEqIupac, 8, 0, 1)     \
  X(kEqIupac, 1, 24, 1) X(kEqIupac, 2, 24, 1) X(kEqIupac, 1, 24, 2)  \
  X(kEqIupac, 2, 24, 2) X(kEqIupac, 2, 24, 4)                        \
  X(kEqIupac, 1, 64, 1) X(kEqIupac, 2, 64, 1) X(kEqIupac, 1, 64, 2)  \
  X(kEqIupac, 2, 64, 2) X(kEqIupac, 2, 64, 4)

// Launches one member on `stream` without synchronising: U patterns per
// thread, the rows unrolled (`unroll` != 0, M among the built row counts)
// or looped, WU words per iteration. Returns the cudaError_t of the
// launch (0 = success); cudaErrorInvalidValue for a member that is not
// built or inputs it does not take (Q % U, NW % WU, M > 64).
extern "C" int sassy_scan_qn(
    const void* win, const void* tile0, const void* pmasks,
    const void* is_pad, const void* h_init, const void* pidx,
    const void* m_real, const void* boundary_m, void* vp_out, void* vm_out,
    void* cost_out, int T, int NW, int P, int M, int Q, int eq_mode, int U,
    int unroll, int WU, void* stream) {
  QArgs qa = {};
  Args& a = qa.base;
  a.win = static_cast<const uint32_t*>(win);
  a.tile0 = static_cast<const uint8_t*>(tile0);
  a.pmasks = static_cast<const uint32_t*>(pmasks);
  a.is_pad = static_cast<const uint32_t*>(is_pad);
  a.h_init = static_cast<const uint32_t*>(h_init);
  a.pidx = static_cast<const int32_t*>(pidx);
  a.vp_out = static_cast<uint32_t*>(vp_out);
  a.vm_out = static_cast<uint32_t*>(vm_out);
  a.cost_out = static_cast<int32_t*>(cost_out);
  a.T = T;
  a.NW = NW;
  a.M = M;
  qa.m_real = static_cast<const int32_t*>(m_real);
  qa.boundary_m = static_cast<const int32_t*>(boundary_m);
  qa.Q = Q;
  if (T <= 0 || NW <= 0 || M <= 0 || M > kRegRows || Q <= 0 || U <= 0 ||
      WU <= 0 || Q % U != 0 || NW % WU != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!eq_inputs_ok(eq_mode, P, pidx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mu = unroll ? M : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SASSY_QN_CASE(EQ_, U_, MU_, WU_)                           \
  if (eq_mode == EQ_ && U == U_ && mu == MU_ && WU == WU_) {       \
    return static_cast<int>(launch_qn<EQ_, U_, MU_, WU_>(qa, s));  \
  }
  SASSY_QN_MEMBERS(SASSY_QN_CASE)
#undef SASSY_QN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
