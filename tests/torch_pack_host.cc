// A host program over sassy_tpu_torch/csrc/pack.cuh, the per-word code of
// the text pack kernel (pack.cu), for tests/test_torch_pack_host.py: built
// with g++, it builds the launch's byte-code table as the kernel's C entry
// point does and packs the words one after another where the kernel's
// threads take them side by side. The same argument list as the kernel's
// C entry point (sassy_pack) without the stream, on host memory; returns 0,
// or 1 for arguments the entry point refuses.

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
