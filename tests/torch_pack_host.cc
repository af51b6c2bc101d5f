// A host program over sassy_tpu_torch/csrc/pack.cuh, the per-word code of
// the text pack kernel (pack.cu), for tests/test_torch_pack_host.py: built
// with g++, it builds the launch's byte-code table as the kernel's C entry
// point does and packs the words one after another where the kernel's
// threads take them side by side. The same argument list as the kernel's
// C entry point (sassy_pack) without the stream, on host memory; returns 0,
// or 1 for arguments the entry point refuses. sassy_pack_set_host does the
// same for the text set's pack (sassy_pack_set): the same checks and
// table, then the kernel's warps one after another, each as the kernel
// runs it (pack_set_words): its range's first text by rounds of 32
// probes, then step by step the lanes' texts (where a lane passed its
// text: the warp's shared-memory staging, every lane's part in turn, then
// each lane's search of it) and each lane's word, every load checked to
// lie inside a text (stats: the loads, those outside every text, the
// vector loads, the stagings, the search rounds).

#include <cstdint>

namespace {
// The text set being packed, for the load check: every byte the set pack
// loads must lie inside one of its texts.
const long long* g_starts = nullptr;
const long long* g_lens = nullptr;
long long g_texts = 0;
long long g_loads = 0;    // loads (a vector load's bytes count once)
long long g_outside = 0;  // loads that left every text
long long g_wide = 0;     // the vector loads among them

void check_read(int64_t first, int64_t count) {
  ++g_loads;
  if (count > 1) ++g_wide;
  for (long long t = 0; t < g_texts; ++t) {
    if (first >= g_starts[t] && first + count <= g_starts[t] + g_lens[t]) {
      return;
    }
  }
  ++g_outside;
}
}  // namespace

#define SASSY_PACK_READ_HOOK(first, count) check_read((first), (count))

#include "pack.cuh"

extern "C" int sassy_pack_host(const void* text, long long len, void* out,
                               long long gw, long long word0, long long nw,
                               int nb, int planes, int with_valid, int mode,
                               int shift, int mask,
                               const unsigned int* pmasks, int fold) {
  if (gw <= 0 || len < 0 || word0 < 0 || nw < 0 || nb < 0 || nb >= 32 ||
      planes < 1 || planes > kPackMaxPlanes || out == nullptr ||
      (mode != kPackModeTable5 && mode != kPackModeByte) || shift < 0 ||
      shift > 7 || mask < 0 || mask > 31 ||
      (mode == kPackModeTable5 && pmasks == nullptr) ||
      (len > 0 && text == nullptr)) {
    return 1;
  }
  uint32_t pm[kPackMaxPlanes] = {};
  if (mode == kPackModeTable5) {
    for (int p = 0; p < planes; ++p) pm[p] = pmasks[p];
  }
  const PackTable tab = pack_table(mode, shift, mask, pm, planes, fold != 0);
  PackArgs a;
  a.text = static_cast<const uint8_t*>(text);
  a.len = len;
  a.out = static_cast<uint32_t*>(out);
  a.gw = gw;
  a.word0 = word0;
  a.nw = nw;
  a.nb = nb;
  a.planes = planes;
  a.with_valid = with_valid != 0;
  const int64_t lim = pack_limit(a);
  const uint8_t* codes = reinterpret_cast<const uint8_t*>(tab.words);
  for (int64_t j = 0; j < gw; ++j) pack_word_host(a, j, lim, codes);
  return 0;
}

extern "C" int sassy_pack_set_host(const void* text, long long len,
                                   const long long* starts,
                                   const long long* lens,
                                   const long long* wofs, long long texts,
                                   void* out, long long width,
                                   long long steps, int reverse, int planes,
                                   int with_valid, int mode, int shift,
                                   int mask, const unsigned int* pmasks,
                                   int fold, long long warps,
                                   long long* stats) {
  PackSetArgs a;
  PackTable tab;
  if (warps < 1 ||
      !pack_set_setup(text, len, starts, lens, wofs, texts, out, width,
                      steps, reverse, planes, with_valid, mode, shift, mask,
                      pmasks, fold, &a, &tab)) {
    return 1;
  }
  g_starts = starts;
  g_lens = lens;
  g_texts = texts;
  g_loads = g_outside = g_wide = 0;
  long long stagings = 0;
  long long rounds = 0;
  const uint8_t* codes = reinterpret_cast<const uint8_t*>(tab.words);
  const int64_t per_warp = set_warp_words(width, warps);
  SetStage s;  // the warp's shared memory
  SetText c[kSetLanes];
  bool open[kSetLanes];
  for (int64_t w_begin = 0; w_begin < width; w_begin += per_warp) {
    const int64_t w_end =
        w_begin + per_warp < width ? w_begin + per_warp : width;
    int64_t lo = -1;
    int64_t hi = a.texts;
    while (lo < hi) {
      int below = 0;  // the ballot's count
      for (int lane = 0; lane < kSetLanes; ++lane) {
        below += a.wofs[set_probe(lo, hi, lane)] <= w_begin;
      }
      set_narrow(&lo, &hi, below);
      ++rounds;
    }
    for (int lane = 0; lane < kSetLanes; ++lane) {
      c[lane] = set_unknown(lo, w_begin);
    }
    for (int64_t w0 = w_begin; w0 < w_end; w0 += kSetLanes) {
      bool any = false;
      for (int lane = 0; lane < kSetLanes; ++lane) {
        open[lane] = w0 + lane >= c[lane].end;
        any = any || open[lane];
      }
      if (any) {
        const int64_t last = c[kSetLanes - 1].t;
        int64_t base = last > 0 ? last : 0;
        do {
          for (int lane = 0; lane < kSetLanes; ++lane) {
            set_stage(a, base, lane, &s);
          }
          ++stagings;
          any = false;
          for (int lane = 0; lane < kSetLanes; ++lane) {
            if (open[lane]) {
              open[lane] = !set_resolve(a, s, base, w0 + lane, &c[lane]);
            }
            any = any || open[lane];
          }
          base += kSetLanes;
        } while (any);
      }
      for (int lane = 0; lane < kSetLanes; ++lane) {
        if (w0 + lane < w_end) pack_set_word(a, w0 + lane, c[lane], codes);
      }
    }
  }
  stats[0] = g_loads;
  stats[1] = g_outside;
  stats[2] = g_wide;
  stats[3] = stagings;
  stats[4] = rounds;
  return 0;
}
