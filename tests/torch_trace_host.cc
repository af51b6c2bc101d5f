// A host program over sassy_tpu_torch/csrc/trace.cuh, the traceback kernel's
// per-candidate work (trace.cu), for tests/test_torch_trace.py: built with
// g++ -ffp-contract=off, it traces the candidates one after another, a
// chunk at a time in the same scratch, as the kernel's launches do
// (sassy_trace_host: the kernel's C entry point's arguments, on host
// memory, all chunks in one call), and decodes positions from the planes
// as the kernel reads its windows (sassy_trace_codes_host).

#include "trace.cuh"

extern "C" int sassy_trace_host(const void* planes, long long L, int P,
                                int eq, const void* pcodes, const void* cand,
                                long long B, const void* tables, int m, int w,
                                int alpha_on, void* out, long long stride,
                                void* E, void* codes, long long chunk) {
  if (P < 1 || P > kTraceMaxPlanes || chunk < 1 ||
      stride < kTraceFields + (m + w + 1 + 3) / 4) {
    return 1;
  }
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
  for (long long b0 = 0; b0 < B; b0 += chunk) {
    const long long n = B - b0 < chunk ? B - b0 : chunk;
    for (long long t = 0; t < n; ++t) trace_one(a, b0, t);
  }
  return 0;
}

extern "C" void sassy_trace_codes_host(const void* planes, long long L, int P,
                                       long long base, int n, void* out) {
  trace_codes(static_cast<const uint32_t*>(planes), L, P, base, n,
              static_cast<uint8_t*>(out), 1);
}
