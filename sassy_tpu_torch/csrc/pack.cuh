// The text pack (pack.cu): a text's bytes -> bit-planes of the engine
// codes, as __host__ __device__ functions. The kernel runs them on the
// card, one thread a 32-position word; a host build of this header
// (tests/torch_pack_host.cc) runs them word after word and holds the
// result to the JAX package's pack without one.
//
// Plane p's word w: bit i = bit p of the code of the byte at position
// 32 * w + i. The code of a byte is one entry of a 256-entry table, built
// once a launch from the profile's pack descriptor (pack_table): "table5"
// gives code bit p of byte b = bit ((b >> shift) & mask) of pmasks[p];
// "byte" the byte itself, ASCII-lowercased with fold. Positions >= n =
// 32 * nw + nb are zero in every plane; the optional validity plane after
// the code planes has bit i set iff the position is < n.
//
// A word's 32 bytes (8 little-endian uint32) become its planes in three
// steps of 32-bit operations (transpose_word): each byte's code is looked
// up and placed so that register R holds the codes of positions R, 8 + R,
// 16 + R and 24 + R in its four bytes, so bit 8 s + k of register R is bit
// k of the code at position 8 s + R; three exchanges of the register
// index's bit a with the bit-in-byte's bit a (a = 0, 1, 2) then make bit
// 8 s + k of register R bit R of the code at position 8 s + k: register p
// is plane p's word.

#pragma once

#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define PACK_HD __host__ __device__ __forceinline__
#else
#define PACK_HD inline
#endif

namespace {

constexpr int kPackModeTable5 = 0;
constexpr int kPackModeByte = 1;
constexpr int kPackMaxPlanes = 8;
constexpr int kWordBytes = 32;

// The 256 byte codes, four to a word (byte b of the table is b's code);
// a kernel argument, copied to shared memory by each block.
struct PackTable {
  uint32_t words[64];
};

struct PackArgs {
  const uint8_t* text;  // positions 32 * word0 .. 32 * word0 + len - 1
  int64_t len;          // bytes the kernel may read from text
  uint32_t* out;        // (planes + with_valid, gw) words, row-major
  int64_t gw;           // output words: words word0 .. word0 + gw - 1
  int64_t word0;        // the word of out's column 0 (and of text[0])
  int64_t nw;           // n = 32 * nw + nb, in positions
  int nb;
  int planes;
  bool with_valid;
};

// The code of byte b: bit p is plane p's bit (p < planes).
PACK_HD uint32_t pack_code(uint32_t b, int mode, int shift, int mask,
                           const uint32_t* pmasks, int planes, bool fold) {
  if (mode == kPackModeByte) {
    if (fold && b >= 65u && b <= 90u) b += 32u;
    return planes >= 8 ? b : b & ((1u << planes) - 1u);
  }
  const uint32_t idx = (b >> shift) & static_cast<uint32_t>(mask);
  uint32_t code = 0;
  for (int p = 0; p < planes; ++p) code |= ((pmasks[p] >> idx) & 1u) << p;
  return code;
}

// The launch's table of the 256 byte codes.
PACK_HD PackTable pack_table(int mode, int shift, int mask,
                             const uint32_t* pmasks, int planes, bool fold) {
  PackTable t;
  for (int w = 0; w < 64; ++w) {
    uint32_t v = 0;
    for (int j = 0; j < 4; ++j) {
      v |= pack_code(static_cast<uint32_t>(4 * w + j), mode, shift, mask,
                     pmasks, planes, fold) << (8 * j);
    }
    t.words[w] = v;
  }
  return t;
}

// Bytes of text that hold a position < n: the kernel reads no other.
PACK_HD int64_t pack_limit(const PackArgs& a) {
  const int64_t need = kWordBytes * (a.nw - a.word0) + a.nb;
  const int64_t lim = need < a.len ? need : a.len;
  return lim > 0 ? lim : 0;
}

// Bits of word word0 + j below position n.
PACK_HD uint32_t n_mask(const PackArgs& a, int64_t j) {
  const int64_t w = a.word0 + j;
  if (w < a.nw) return 0xFFFFFFFFu;
  if (w > a.nw) return 0u;
  return (1u << a.nb) - 1u;  // nb < 32
}

// Word j's bytes below lim, one at a time; zeros past it.
PACK_HD void load_word_bytes(const PackArgs& a, int64_t j, int64_t lim,
                             uint32_t x[8]) {
  const int64_t b0 = kWordBytes * j;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t b = b0 + 4 * m + i;
      if (b < lim) v |= static_cast<uint32_t>(a.text[b]) << (8 * i);
    }
    x[m] = v;
  }
}

// Swap bit a of the register index with bit a of the bit-in-byte index:
// registers R and R | (1 << a), the bits of byte-bit a set in R against
// those clear in R | (1 << a).
template <int A>
PACK_HD void exchange(uint32_t r[8]) {
  constexpr int d = 1 << A;
  constexpr uint32_t m = A == 0 ? 0x55555555u
                       : A == 1 ? 0x33333333u : 0x0F0F0F0Fu;
#pragma unroll
  for (int R = 0; R < 8; ++R) {
    if (R & d) continue;
    const uint32_t t = ((r[R] >> d) ^ r[R | d]) & m;
    r[R | d] ^= t;
    r[R] ^= t << d;
  }
}

// A word's 32 bytes x -> its 8 code planes r (see the top of the file).
PACK_HD void transpose_word(const uint32_t x[8], const uint8_t* codes,
                            uint32_t r[8]) {
#pragma unroll
  for (int R = 0; R < 8; ++R) {
    const int shift = 8 * (R & 3);
    uint32_t v = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t b = (x[2 * s + (R >> 2)] >> shift) & 0xFFu;
      v |= static_cast<uint32_t>(codes[b]) << (8 * s);
    }
    r[R] = v;
  }
  exchange<0>(r);
  exchange<1>(r);
  exchange<2>(r);
}

// Word j's planes, zero at positions >= n, and the validity plane (the
// loop runs over all eight registers so that r stays in registers).
PACK_HD void store_word(const PackArgs& a, int64_t j, const uint32_t r[8],
                        uint32_t nmask) {
#pragma unroll
  for (int p = 0; p < kPackMaxPlanes; ++p) {
    if (p < a.planes) a.out[p * a.gw + j] = r[p] & nmask;
  }
  if (a.with_valid) a.out[a.planes * a.gw + j] = nmask;
}

// Word j on the host, as the kernel takes it: zero past lim, else its
// bytes below lim (a full word in one copy), its planes; then its store.
inline void pack_word_host(const PackArgs& a, int64_t j, int64_t lim,
                           const uint8_t* codes) {
  uint32_t r[8] = {};
  if (kWordBytes * j < lim) {
    uint32_t x[8];
    if (kWordBytes * (j + 1) <= lim) {
      std::memcpy(x, a.text + kWordBytes * j, kWordBytes);
    } else {
      load_word_bytes(a, j, lim, x);
    }
    transpose_word(x, codes, r);
  }
  store_word(a, j, r, n_mask(a, j));
}

}  // namespace
