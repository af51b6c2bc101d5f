// Single-pattern Myers'99 word scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel get_pallas_scan ("q1") of
// sassy_tpu/ops/myers_pallas.py. It computes what that kernel computes: for
// each tile of halo-tiled text and each 32-position word of its window,
// the last pattern row's vertical delta words (vp, vm) and its cost at the
// word start, from the tile's initial state (the true-start h deltas and
// boundary cost where tile0 is set, the plain cost-j boundary elsewhere).
// The overhang search's position-level path (TorchEngine with more than
// four overshoot words) expands these to per-position costs.
//
// What bounds it on the H100: integer issue, as for q1meta (scan_meta.cu):
// about 20 integer operations per pattern row per window word against P
// plane words read and three output words written; at M = 120 that is
// ~2,400 operations per 28 bytes. Without the metadata epilogue it writes
// 12 bytes per word where q1meta writes 16.
//
// It is q1meta's per-tile scan (myers_step.cuh's scan_block) with the
// metadata switched off at compile time: one thread per tile, (NW, P, T)
// windows, carries bit-packed in registers for M <= 64 and in device
// memory beyond, pattern rows in shared memory; the iupac, pure and ascii
// eq. Built by sassy_tpu_torch/ops/myers_cuda.py with one nvcc call,
// together with the other scan kernels.

#include "myers_step.cuh"

namespace {

template <int EQ, bool REG>
__global__ void __launch_bounds__(kThreads) scan_kernel(const Args a) {
  scan_block<EQ, REG, false>(a, blockIdx.x);
}

template <int EQ>
cudaError_t launch_eq(const Args& a, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((a.T + kThreads - 1) / kThreads);
  const size_t smem = smem_bytes<EQ>(a.M);
  return a.M <= kRegRows
             ? launch_blocks(scan_kernel<EQ, true>, a, smem, blocks, stream)
             : launch_blocks(scan_kernel<EQ, false>, a, smem, blocks, stream);
}

}  // namespace

// Launches the scan on `stream` without synchronising; returns the
// cudaError_t of the launch (0 = success).
extern "C" int sassy_scan(
    const void* win, const void* tile0, const void* pmasks,
    const void* is_pad, const void* h_init, const void* pidx, void* vp_out,
    void* vm_out, void* cost_out, void* carries, int T, int NW, int P, int M,
    int m_real, int boundary_m, int eq_mode, void* stream) {
  Args a = {};
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
  a.m_real = m_real;
  a.boundary_m = boundary_m;
  if (T <= 0 || NW <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((M > kRegRows) != (carries != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!eq_inputs_ok(eq_mode, P, pidx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (eq_mode) {
    case kEqIupac:
      return static_cast<int>(launch_eq<kEqIupac>(a, s));
    case kEqPure:
      return static_cast<int>(launch_eq<kEqPure>(a, s));
    default:
      return static_cast<int>(launch_eq<kEqAscii>(a, s));
  }
}
