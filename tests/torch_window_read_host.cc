// A host program over sassy_tpu_torch/csrc/window_read.cuh, the scan
// kernels' window read (myers_step.cuh's scan_block), for
// tests/test_torch_window_reads.py: built with g++, it runs the read of
// each tile one after another where the kernels' threads run them side by
// side, and writes the words the read hands the scan as an (NW, P, T)
// window array. Every group it loads is checked to lie inside the planes.

#include <cstddef>
#include <cstdint>

namespace {
const uint32_t* g_lo = nullptr;  // the planes' first word
const uint32_t* g_hi = nullptr;  // one past their last
long long g_outside = 0;         // loads that left the planes
long long g_loads = 0;
}  // namespace

#define SASSY_WINDOW_READ_HOOK(p, n)                     \
  do {                                                   \
    ++g_loads;                                           \
    if ((p) < g_lo || (p) + (n) > g_hi) ++g_outside;     \
  } while (0)

#include "window_read.cuh"

template <int P>
static void read_tiles(const WindowDesc& d, int T, int NW, uint32_t* out) {
  for (int t = 0; t < T; ++t) {
    for_each_window_word<P>(d, t, NW, [&](int w, const uint32_t (&x)[P]) {
      for (int p = 0; p < P; ++p) {
        out[(static_cast<size_t>(w) * P + p) * T + t] = x[p];
      }
    });
  }
}

// The words the kernels read for T tiles of NW window words from (P, L)
// planes, into out (NW, P, T); stats[0] the loads, stats[1] those outside
// the planes. Returns 0, or 1 for arguments the kernels' entry points
// refuse (P other than 4 and 9, L not a multiple of the row alignment).
extern "C" int sassy_window_read_host(const void* planes, long long L, int P,
                                      const void* wstart, const void* wend,
                                      int T, int NW, void* out,
                                      long long* stats) {
  if (planes == nullptr || wstart == nullptr || wend == nullptr || L <= 0 ||
      L % kPlaneAlignWords != 0 || (P != 4 && P != 9) || T < 0 || NW < 1) {
    return 1;
  }
  const WindowDesc d = {static_cast<const uint32_t*>(planes),
                        static_cast<const int64_t*>(wstart),
                        static_cast<const int64_t*>(wend), L};
  g_lo = d.planes;
  g_hi = d.planes + static_cast<size_t>(P) * L;
  g_outside = 0;
  g_loads = 0;
  uint32_t* o = static_cast<uint32_t*>(out);
  if (P == 4) {
    read_tiles<4>(d, T, NW, o);
  } else {
    read_tiles<9>(d, T, NW, o);
  }
  stats[0] = g_loads;
  stats[1] = g_outside;
  return 0;
}

