// A host program over sassy_tpu_torch/csrc/trace.cuh, the traceback kernel's
// per-candidate work (trace.cu), for tests/test_torch_trace.py: built with
// g++ -ffp-contract=off, it traces the candidates one after another, a
// chunk at a time in the same scratch of delta words, with the
// instantiation the kernel's launch picks (sassy_trace_host: the kernel's C
// entry point's arguments, on host memory, all chunks in one call), and
// decodes positions from the planes as the kernel reads its windows, a
// funnel-shifted word at a time (sassy_trace_codes_host).

#include "trace.cuh"

namespace {

struct HostRun {
  const TraceArgs& a;

  template <int EQ, int NP, int G>
  int run() {
    for (long long b0 = 0; b0 < a.B; b0 += a.chunk) {
      const long long n = a.B - b0 < a.chunk ? a.B - b0 : a.chunk;
      for (long long t = 0; t < n; ++t) {
        TraceCell stage[kTraceStageRows];
        uint32_t stage_codes[kTraceStageRows];
        trace_one<EQ, NP, G>(a, b0, t, stage, stage_codes, 1);
      }
    }
    return 0;
  }
};

}  // namespace

extern "C" int sassy_trace_host(const void* planes, long long L, int P,
                                int eq, const void* pcodes, const void* cand,
                                long long B, const void* tables, int m, int w,
                                int alpha_on, void* out, long long stride,
                                void* cells, long long chunk) {
  if (P < 1 || P > kTraceMaxPlanes || chunk < 1 ||
      (eq != kTraceEqAnd && eq != kTraceEqByte) ||
      stride < kTraceFields + (m + w + 1 + 3) / 4) {
    return 1;
  }
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
  HostRun run{a};
  return trace_dispatch(eq, P, a.nw, run);
}

extern "C" void sassy_trace_codes_host(const void* planes, long long L, int P,
                                       long long base, int n, void* out) {
  uint32_t x[kTraceMaxPlanes];
  for (int c = 0; c < n; ++c) {
    if ((c & 31) == 0) {
      trace_window_word<kTraceMaxPlanes>(static_cast<const uint32_t*>(planes),
                                         L, P, base, c >> 5, x);
    }
    static_cast<uint8_t*>(out)[c] =
        static_cast<uint8_t>(trace_code<kTraceMaxPlanes>(x, c & 31));
  }
}

