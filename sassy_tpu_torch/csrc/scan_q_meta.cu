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
//   pattern, so a warp's loads and stores are 32 adjacent tiles, and the
//   pattern's rows sit in the block's shared memory (myers_step.cuh);
// - the grid runs the Q blocks of one tile range next to each other
//   (block b: pattern b % Q, tiles b / Q), so a window word comes from
//   device memory once and from the 50 MB L2 for the other Q - 1
//   patterns;
// - carries bit-packed in registers for M <= 64, in device memory laid
//   out [pattern][word][tile] beyond that.
//
// Where the TPU ran two patterns per program to fill its VLIW slots over
// (8, 128) lane blocks, the card's parallelism comes from the Q x T
// threads themselves.

#include <climits>

#include "myers_step.cuh"

namespace {

// Q patterns: `base` holds the shared windows and tile vectors, and the
// pointers of pattern 0; the kernel offsets them per pattern.
struct QArgs {
  Args base;
  const int32_t* m_real;      // (Q,) unpadded pattern lengths
  const int32_t* boundary_m;  // (Q,) cost at the text start, row m
  int Q;
};

template <int EQ, bool REG>
__global__ void __launch_bounds__(kThreads) scan_q_meta_kernel(const QArgs qa) {
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
  a.meta_out += words;
  a.final_out += static_cast<size_t>(q) * T;
  if (!REG) a.carries += static_cast<size_t>(q) * 2 * ((M + 31) / 32) * T;
  a.m_real = qa.m_real[q];
  a.boundary_m = qa.boundary_m[q];
  scan_block<EQ, REG>(a, block);
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
    const void* win, const void* tile0, const void* vfrom, const void* vto,
    const void* pmasks, const void* is_pad, const void* h_init,
    const void* pidx, const void* m_real, const void* boundary_m,
    void* vp_out, void* vm_out, void* cost_out, void* meta_out,
    void* final_out, void* carries, int T, int NW, int P, int M, int Q,
    int k, int eq_mode, void* stream) {
  QArgs qa;
  Args& a = qa.base;
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
  if (!eq_inputs_ok(eq_mode, P, pidx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tile_blocks = (static_cast<long long>(T) + kThreads - 1) / kThreads;
  const long long blocks = tile_blocks * Q;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nb = static_cast<unsigned>(blocks);
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
