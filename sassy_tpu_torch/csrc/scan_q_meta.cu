// Pattern-batched Myers'99 word scan with selection metadata, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel get_pallas_scan_q2_meta ("q2meta") of
// sassy_tpu/ops/myers_pallas.py. It computes what that kernel computes:
// the q1meta scan (scan_meta.cu) of Q patterns over the same windows,
// each pattern with its own row masks, pad rows, h-init, unpadded length
// m_real and boundary cost. Outputs vp, vm, cost and meta are (Q, NW, T),
// final is (Q, T); pattern q's slice equals what q1meta gives for it.
//
// What bounds it on the H100: integer issue, as for q1meta: about 20
// integer operations per pattern row per window word. The windows are
// shared, so the text bytes read per operation fall by a factor of Q;
// each (pattern, word) writes 16 bytes of outputs.
//
// What the design does about it:
// - one thread per (tile, pattern): a block is 256 adjacent tiles of one
//   pattern, so a warp's stores are 32 adjacent tiles, and the pattern's
//   rows sit in the block's shared memory (myers_step.cuh);
// - each tile's words read straight from the packed planes through its
//   (wstart, wend) descriptor (window_read.cuh): no window copy;
// - the grid runs the Q blocks of one tile range next to each other
//   (block b: pattern b % Q, tiles b / Q; myers_step.cuh's scan_q_block),
//   so a plane word comes from device memory once and from the 50 MB L2
//   for the other Q - 1 patterns;
// - carries bit-packed in registers for M <= 64, in device memory laid
//   out [pattern][word][tile] beyond that.
//
// Where the TPU ran two patterns per program to fill its VLIW slots over
// (8, 128) lane blocks, the card's parallelism comes from the Q x T
// threads themselves.

#include "myers_step.cuh"

namespace {

template <int EQ, bool REG>
__global__ void __launch_bounds__(kThreads, kScanMinBlocks)
scan_q_meta_kernel(const QArgs qa) {
  scan_q_block<EQ, REG, true>(qa);
}

template <int EQ>
cudaError_t launch_eq(const QArgs& qa, unsigned blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes<EQ>(qa.base.M);
  return qa.base.M <= kRegRows
             ? launch_blocks(scan_q_meta_kernel<EQ, true>, qa, smem, blocks,
                             stream)
             : launch_blocks(scan_q_meta_kernel<EQ, false>, qa, smem, blocks,
                             stream);
}

}  // namespace

// Launches the scan of Q patterns on `stream` without synchronising;
// returns the cudaError_t of the launch (0 = success).
extern "C" int sassy_scan_q_meta(
    const void* planes, const void* wstart, const void* wend, long long L,
    const void* tile0, const void* vfrom, const void* vto,
    const void* pmasks, const void* is_pad, const void* h_init,
    const void* pidx, const void* m_real, const void* boundary_m,
    void* vp_out, void* vm_out, void* cost_out, void* meta_out,
    void* final_out, void* carries, int T, int NW, int P, int M, int Q,
    int k, int eq_mode, void* stream) {
  QArgs qa = {};
  Args& a = qa.base;
  set_windows(a, planes, wstart, wend, L);
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
  a.m_real = 0;      // per pattern, from qa.m_real
  a.boundary_m = 0;  // per pattern, from qa.boundary_m
  a.k = k;
  qa.m_real = static_cast<const int32_t*>(m_real);
  qa.boundary_m = static_cast<const int32_t*>(boundary_m);
  qa.Q = Q;
  if (T <= 0 || NW <= 0 || M <= 0 || Q <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((M > kRegRows) != (carries != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!eq_inputs_ok(eq_mode, P, pidx) ||
      !window_inputs_ok(planes, wstart, wend, L)) {
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
