// The host finish's traceback for Hopper (sm_90a): each candidate's window
// read from the strand's bit-planes, its windowed DP filled as Myers words
// and its greedy walk taken on the delta words, on the card, one thread a
// candidate (the work in trace.cuh).
//
// Replaces no TPU kernel: it replaces the host code that the JAX package
// runs after its kernels for every candidate it keeps, the window gather,
// _fill_batch (sassy_tpu/traceback.py:37) and _walk_batch (:119) of
// trace_candidates_batch (:76), called from _postprocess
// (sassy_tpu/search.py:732). The port ran them as numpy (the plain version,
// traceback.trace_plain), one window gather, one pass a pattern row and one
// round a walk step over all candidates of a pattern length.
//
// What bounds it on the H100: operations, one a DP cell and a walk step
// (diagnostics.trace_bound); the bytes it must move are each window's
// plane words and each output row, a few hundred bytes a candidate. A row
// is a chain along the window and a column one down the pattern, so one
// thread fills one candidate; candidates are independent. Few candidates
// (the single path's: one block on one SM) leave the card nearly idle, and
// then one thread's chain of instructions is the time: a single warp on an
// SM sub-partition issues an integer instruction every two cycles at best
// and waits out each dependent one.
//
// What the design does about it: the fill is one Myers step (myers_word.cuh)
// a (pattern row, 32 window columns), not 32 dependent cell updates, with
// no memory round trip: the window's words in registers (up to
// kTraceGroupMax, a longer window in groups of them) stepping in a
// wavefront, so that a thread issues its words' steps side by side, their
// pattern codes' masks passed along the words, no branch inside a time
// step. Each step's four delta words go to a device scratch interleaved by
// candidate (adjacent threads, adjacent 16-byte cells), laid out by
// anti-diagonal so that a time step's cells are one run: 16 bytes for 32
// cells. The walk keeps the current cost and reads two delta bits a
// neighbour from kTraceStageRows rows of cells staged at once in the
// block's shared memory. The scratch holds one chunk of candidates (the
// caller's chunk, under traceback.FILL_BYTES), one launch a chunk; the
// outputs of all chunks are one device buffer, copied to the host once.
// Positions and plane words are 64-bit. Sassy's warp a candidate
// (trace.rs:107-178's lanes) is untried: it would take the long windows'
// fill off one thread's chain, not the walk.

#include "trace.cuh"

namespace {

template <int EQ, int NP, int G>
__global__ void __launch_bounds__(kTraceThreads)
trace_windows(TraceArgs a, int64_t b0, int64_t n) {
  // each thread's walk stage, interleaved by thread (no bank conflicts)
  __shared__ TraceCell stage[kTraceStageRows * kTraceThreads];
  __shared__ uint32_t stage_codes[kTraceStageRows * kTraceThreads];
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kTraceThreads + threadIdx.x;
  if (t < n) {
    trace_one<EQ, NP, G>(a, b0, t, stage + threadIdx.x,
                         stage_codes + threadIdx.x, kTraceThreads);
  }
}

// One launch of the instantiation trace_dispatch picks.
struct TraceLaunch {
  const TraceArgs& a;
  int64_t b0, n;
  cudaStream_t stream;

  template <int EQ, int NP, int G>
  int run() {
    const unsigned blocks =
        static_cast<unsigned>((n + kTraceThreads - 1) / kTraceThreads);
    trace_windows<EQ, NP, G><<<blocks, kTraceThreads, 0, stream>>>(a, b0, n);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// Trace candidates b0 .. b0 + n - 1 (n <= chunk) of the B in `cand`: one
// launch. `cells`: the scratch, chunk x (m + nwp) x nwp TraceCells (16
// bytes each, 16-byte aligned; nwp: ceil(w / 32) rounded up to the fill's
// group of words, myers_cuda.trace_cells). Returns a cudaError_t (0:
// launched).
extern "C" int sassy_trace(const void* planes, long long L, int P, int eq,
                           const void* pcodes, const void* cand, long long B,
                           const void* tables, int m, int w, int alpha_on,
                           void* out, long long stride, void* cells,
                           long long chunk, long long b0, long long n,
                           void* stream) {
  if (P < 1 || P > kTraceMaxPlanes ||
      (eq != kTraceEqAnd && eq != kTraceEqByte) || m < 0 || w < 0 ||
      L < 0 || chunk < 1 || n < 0 || n > chunk || b0 < 0 ||
      b0 + n > B || stride < kTraceFields + (m + w + 1 + 3) / 4 ||
      planes == nullptr || cand == nullptr || tables == nullptr ||
      out == nullptr || (m > 0 && w > 0 && cells == nullptr) ||
      reinterpret_cast<uintptr_t>(cells) % alignof(TraceCell) != 0 ||
      (m > 0 && pcodes == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  TraceArgs a;
  a.planes = static_cast<const uint32_t*>(planes);
  a.L = L;
  a.P = P;
  a.pcodes = static_cast<const uint8_t*>(pcodes);
  a.cand = static_cast<const int64_t*>(cand);
  a.B = B;
  a.tables = static_cast<const int32_t*>(tables);
  a.m = m;
  a.w = w;
  a.nw = (w + 31) / 32;
  a.alpha_on = alpha_on != 0;
  a.out = static_cast<int32_t*>(out);
  a.stride = stride;
  a.cells = static_cast<TraceCell*>(cells);
  a.chunk = chunk;
  TraceLaunch launch{a, b0, n, static_cast<cudaStream_t>(stream)};
  return trace_dispatch(eq, P, a.nw, launch);
}
