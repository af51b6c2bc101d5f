// The host finish's traceback for Hopper (sm_90a): each candidate's window
// read from the strand's bit-planes, its windowed DP filled and its greedy
// walk taken on the card, one thread a candidate (the work in trace.cuh).
//
// Replaces no TPU kernel: it replaces the host code that the JAX package
// runs after its kernels for every candidate it keeps, the window gather,
// _fill_batch (sassy_tpu/traceback.py:37) and _walk_batch (:119) of
// trace_candidates_batch (:76), called from _postprocess
// (sassy_tpu/search.py:732). The port ran them as numpy (the plain version,
// traceback.trace_plain), one window gather, one pass a pattern row and one
// round a walk step over all candidates of a pattern length: 115-120 ms a
// strand at 16,752 candidates of 24 bp, and m steps of fixed host cost
// however few the candidates (6.7-9.5 ms for 2 candidates of 120 bp).
//
// What bounds it on the H100: operations, one ALU operation a DP cell and a
// walk step (diagnostics.trace_bound); the bytes it must move are each
// window's plane words and each output row, a few hundred bytes a
// candidate. The cells are a dependent chain along a row, so one thread
// fills one candidate's matrix; candidates are independent.
//
// What the design does about it (a first design, right before fast): one
// thread a candidate, its E matrix (the DP less its column) and its
// window's codes in a device scratch interleaved by candidate, so that a
// warp's fill reads and writes adjacent words; a fill loads the row above
// kTraceAhead columns at a time before it steps through them. The scratch
// holds one chunk of candidates (at most traceback.FILL_BYTES), one launch
// a chunk. The outputs of all chunks are one device buffer, copied to the
// host once. Positions and plane words are 64-bit. Sassy's own design (the
// Myers vp/vm columns of trace.rs:107-178, each cost a popcount, a warp a
// candidate) is later work.

#include "trace.cuh"

namespace {

__global__ void __launch_bounds__(kTraceThreads)
trace_windows(TraceArgs a, int64_t b0, int64_t n) {
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kTraceThreads + threadIdx.x;
  if (t < n) trace_one(a, b0, t);
}

}  // namespace

// Trace candidates b0 .. b0 + n - 1 (n <= chunk) of the B in `cand`: one
// launch. Returns a cudaError_t (0: launched).
extern "C" int sassy_trace(const void* planes, long long L, int P, int eq,
                           const void* pcodes, const void* cand, long long B,
                           const void* tables, int m, int w, int alpha_on,
                           void* out, long long stride, void* E, void* codes,
                           long long chunk, long long b0, long long n,
                           void* stream) {
  if (P < 1 || P > kTraceMaxPlanes ||
      (eq != kTraceEqAnd && eq != kTraceEqByte) || m < 0 || w < 0 ||
      L < 0 || chunk < 1 || n < 0 || n > chunk || b0 < 0 ||
      b0 + n > B || stride < kTraceFields + (m + w + 1 + 3) / 4 ||
      planes == nullptr || cand == nullptr || tables == nullptr ||
      out == nullptr || E == nullptr || codes == nullptr ||
      (m > 0 && pcodes == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  TraceArgs a;
  a.planes = static_cast<const uint32_t*>(planes);
  a.L = L;
  a.P = P;
  a.eq = eq;
  a.pcodes = static_cast<const uint8_t*>(pcodes);
  a.cand = static_cast<const int64_t*>(cand);
  a.B = B;
  a.tables = static_cast<const int32_t*>(tables);
  a.m = m;
  a.w = w;
  a.alpha_on = alpha_on != 0;
  a.out = static_cast<int32_t*>(out);
  a.stride = stride;
  a.E = static_cast<int32_t*>(E);
  a.codes = static_cast<uint8_t*>(codes);
  a.chunk = chunk;
  const unsigned blocks =
      static_cast<unsigned>((n + kTraceThreads - 1) / kTraceThreads);
  trace_windows<<<blocks, kTraceThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, b0, n);
  return static_cast<int>(cudaGetLastError());
}
