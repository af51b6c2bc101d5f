// Pattern-batched Myers'99 word scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel get_pallas_scan_q2 ("q2") of
// sassy_tpu/ops/myers_pallas.py. It computes what that kernel computes: the
// q1 scan (scan.cu) of Q patterns over the same windows, each pattern with
// its own row masks, pad rows, h-init, unpadded length m_real and boundary
// cost. Outputs vp, vm and cost are (Q, NW, T); pattern q's slice equals
// what q1 gives for it. The batched overhang search's position-level path
// (BatchEngine with more than four overshoot words) expands them to
// per-position costs.
//
// What bounds it on the H100: integer issue, as for q1: about 20 integer
// operations per pattern row per window word. The windows are shared, so
// the text bytes read per operation fall by a factor of Q; each (pattern,
// word) writes 12 bytes of outputs.
//
// It is q2meta's grid (myers_step.cuh's scan_q_block: one thread per
// (tile, pattern), the Q blocks of a tile range adjacent, so window words
// come from L2 for all but the first pattern) with the metadata switched
// off at compile time. Q need not be even: where the TPU ran two patterns
// per program over (8, 128) lane blocks, the card takes any Q.

#include "myers_step.cuh"

namespace {

template <int EQ, bool REG>
__global__ void __launch_bounds__(kThreads) scan_q_kernel(const QArgs qa) {
  scan_q_block<EQ, REG, false>(qa);
}

template <int EQ>
cudaError_t launch_eq(const QArgs& qa, unsigned blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes<EQ>(qa.base.M);
  return qa.base.M <= kRegRows
             ? launch_blocks(scan_q_kernel<EQ, true>, qa, smem, blocks, stream)
             : launch_blocks(scan_q_kernel<EQ, false>, qa, smem, blocks,
                             stream);
}

}  // namespace

// Launches the scan of Q patterns on `stream` without synchronising;
// returns the cudaError_t of the launch (0 = success).
extern "C" int sassy_scan_q(
    const void* win, const void* tile0, const void* pmasks,
    const void* is_pad, const void* h_init, const void* pidx,
    const void* m_real, const void* boundary_m, void* vp_out, void* vm_out,
    void* cost_out, void* carries, int T, int NW, int P, int M, int Q,
    int eq_mode, void* stream) {
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
  a.carries = static_cast<uint32_t*>(carries);
  a.T = T;
  a.NW = NW;
  a.M = M;
  qa.m_real = static_cast<const int32_t*>(m_real);
  qa.boundary_m = static_cast<const int32_t*>(boundary_m);
  qa.Q = Q;
  if (T <= 0 || NW <= 0 || M <= 0 || Q <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((M > kRegRows) != (carries != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!eq_inputs_ok(eq_mode, P, pidx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned nb = q_blocks(T, Q);
  if (nb == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (eq_mode) {
    case kEqIupac:
      return static_cast<int>(launch_eq<kEqIupac>(qa, nb, s));
    case kEqPure:
      return static_cast<int>(launch_eq<kEqPure>(qa, nb, s));
    default:
      return static_cast<int>(launch_eq<kEqAscii>(qa, nb, s));
  }
}
