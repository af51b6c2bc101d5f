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
//   ~0.5M tiles in flight for a 1 GiB text); the outputs in the (NW, T)
//   layout, so a warp's stores of one word are 32 adjacent tiles;
// - the text read straight from the packed planes (window_read.cuh): a
//   tile is two numbers (wstart, wend), so no window copy of the planes
//   is made, kept or gathered; a thread holds its next words in a
//   register ring of vector loads, one a plane every few words, since its
//   neighbours' windows lie W words away;
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
// The per-tile scan is myers_step.cuh's scan_block, shared with the
// other scan kernels. Built by sassy_tpu_torch/ops/myers_cuda.py with one
// nvcc call, together with them, into one shared library with plain C
// entry points, loaded with ctypes.

#include "myers_step.cuh"

namespace {

template <int EQ, bool REG>
__global__ void __launch_bounds__(kThreads, kScanMinBlocks)
scan_meta_kernel(const Args a) {
  scan_block<EQ, REG, true>(a, blockIdx.x);
}

template <int EQ>
cudaError_t launch_eq(const Args& a, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((a.T + kThreads - 1) / kThreads);
  const size_t smem = smem_bytes<EQ>(a.M);
  return a.M <= kRegRows
             ? launch_blocks(scan_meta_kernel<EQ, true>, a, smem, blocks, stream)
             : launch_blocks(scan_meta_kernel<EQ, false>, a, smem, blocks, stream);
}

}  // namespace

// Launches the scan on `stream` without synchronising; returns the
// cudaError_t of the launch (0 = success).
extern "C" int sassy_scan_meta(
    const void* planes, const void* wstart, const void* wend, long long L,
    const void* tile0, const void* vfrom, const void* vto,
    const void* pmasks, const void* is_pad, const void* h_init,
    const void* pidx, void* vp_out, void* vm_out, void* cost_out,
    void* meta_out, void* final_out, void* carries, int T, int NW, int P,
    int M, int m_real, int boundary_m, int k, int eq_mode, void* stream) {
  Args a = {};
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
  a.m_real = m_real;
  a.boundary_m = boundary_m;
  a.k = k;
  if (T <= 0 || NW <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((M > kRegRows) != (carries != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!eq_inputs_ok(eq_mode, P, pidx) ||
      !window_inputs_ok(planes, wstart, wend, L)) {
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
