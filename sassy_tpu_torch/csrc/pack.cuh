// The text pack (pack.cu): a text's bytes -> bit-planes of the engine
// codes, as __host__ __device__ functions. The kernels run them on the
// card, one thread a 32-position word; a host build of this header
// (tests/torch_pack_host.cc) runs them word after word and holds the
// result to the JAX package's pack without one. The text set's pack, for
// many texts, forwards or backwards and with the overhang's 'N's, is
// further down (PackSetArgs).
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

// -- the text set's pack (pack_set_words in pack.cu) -------------------------
//
// The planes of a batch of texts in one launch. The texts lie in one byte
// buffer, text t's n_t bytes from byte starts[t]; its plane words are
// wofs[t] .. wofs[t + 1] - 1, ceil((n_t + steps) / 32) of them. Word j of
// text t holds its positions 32 j .. 32 j + 31, read forwards (position i
// is byte i) or, with reverse, backwards (position i is byte n_t - 1 - i,
// so a reversed word is a byte-reversed span of the forward bytes).
// Positions n_t .. n_t + steps - 1 are 'N': every plane bit set (IUPAC's
// overhang_pad_code 15), the validity bit too; positions past them, and
// the words from wofs[texts] up to the width, are zero in every plane.
//
// Which text holds a word: each warp packs one contiguous range of plane
// words (set_warp_words), lane l word w0 + l of each step of 32. A lane
// keeps its word's text (SetText) while its words stay below that text's
// end. When a lane passes its text, the warp stages the table entries of
// the 32 texts from its last lane's text on in shared memory (SetStage),
// one a lane, and each lane that passed finds its text there by a binary
// search over the 32 ends (set_resolve); more than 32 texts ending within
// the warp's 32 words (empty texts) take another round. A range starts
// from one search of the whole table, 32 probes a round (set_probe,
// set_narrow). So a word's text costs O(1) table reads amortised, and
// nothing searches the table per word.

constexpr int kSetLanes = 32;
constexpr int64_t kSetNoEnd = INT64_MAX;

struct PackSetArgs {
  const uint8_t* text;    // the texts' bytes
  int64_t len;            // bytes the kernel may read from text
  const int64_t* starts;  // (texts,) each text's first byte
  const int64_t* lens;    // (texts,) its length n_t
  const int64_t* wofs;    // (texts + 1,) its first plane word; the total
  int64_t texts;
  uint32_t* out;          // (planes + with_valid, width) words, row-major
  int64_t width;
  int64_t steps;
  int planes;
  bool with_valid;
  bool reverse;
  bool aligned;           // text is 16-byte aligned: vector loads allowed
};

// A lane's text: t in 0 .. texts - 1 with its table entry, -1 before the
// first text, texts past them all; the lane's words below end stay in it.
struct SetText {
  int64_t t;
  int64_t first;  // wofs[t]
  int64_t end;    // wofs[t + 1]; wofs[0] before the first, kSetNoEnd past
  int64_t start;  // starts[t]
  int64_t len;    // lens[t]
};

// A warp's staged table entries: lane l's of text base + l; a lane past
// the last text holds none (its first and end kSetNoEnd).
struct SetStage {
  int64_t first[kSetLanes];
  int64_t end[kSetLanes];
  int64_t start[kSetLanes];
  int64_t len[kSetLanes];
};

// Plane words each warp packs: the width over `warps` warps, a multiple
// of 32.
PACK_HD int64_t set_warp_words(int64_t width, int64_t warps) {
  const int64_t per = (width + warps - 1) / warps;
  return (per + kSetLanes - 1) / kSetLanes * kSetLanes;
}

// Lane `lane`'s probe in one round of the search for the last text t with
// wofs[t] <= w, known to lie in [lo, hi]: 32 rising indices in (lo, hi],
// the last hi.
PACK_HD int64_t set_probe(int64_t lo, int64_t hi, int lane) {
  return lo + ((hi - lo) * (lane + 1) + kSetLanes - 1) / kSetLanes;
}

// [lo, hi] after a round whose first c probes had wofs[probe] <= w; the
// search ends when lo == hi (lo starts at -1, hi at texts).
PACK_HD void set_narrow(int64_t* lo, int64_t* hi, int c) {
  const int64_t l = *lo;
  const int64_t h = *hi;
  if (c > 0) *lo = set_probe(l, h, c - 1);
  if (c < kSetLanes) *hi = set_probe(l, h, c) - 1;
}

// A lane's state before its range's first step: text t, no words in it,
// so the warp stages from t.
PACK_HD SetText set_unknown(int64_t t, int64_t w) {
  SetText c = {};
  c.t = t;
  c.end = w;
  return c;
}

// Lane `lane`'s part of staging the texts base .. base + 31.
PACK_HD void set_stage(const PackSetArgs& a, int64_t base, int lane,
                       SetStage* s) {
  const int64_t t = base + lane;
  if (t < a.texts) {
    s->first[lane] = a.wofs[t];
    s->end[lane] = a.wofs[t + 1];
    s->start[lane] = a.starts[t];
    s->len[lane] = a.lens[t];
  } else {
    s->first[lane] = s->end[lane] = kSetNoEnd;
    s->start[lane] = s->len[lane] = 0;
  }
}

// The first staged lane whose text ends past word w, 32 if none: a binary
// search over the ends, which rise lane by lane.
PACK_HD int set_find(const SetStage& s, int64_t w) {
  int i = 0;  // every lane below i ends at or before w
#pragma unroll
  for (int step = kSetLanes / 2; step >= 1; step /= 2) {
    if (s.end[i + step - 1] <= w) i += step;
  }
  return s.end[i] <= w ? i + 1 : i;
}

// Word w's text among the staged texts base ..: sets *c and returns true,
// or false where its text lies past them.
PACK_HD bool set_resolve(const PackSetArgs& a, const SetStage& s,
                         int64_t base, int64_t w, SetText* c) {
  const int i = set_find(s, w);
  const int64_t left = a.texts - base;
  const int64_t count = left < kSetLanes ? left : kSetLanes;
  if (i < count) {
    if (w < s.first[i]) {  // before the first text (wofs[0] > w)
      *c = set_unknown(-1, s.first[i]);
    } else {
      c->t = base + i;
      c->first = s.first[i];
      c->end = s.end[i];
      c->start = s.start[i];
      c->len = s.len[i];
    }
    return true;
  }
  if (base + count >= a.texts) {  // past every text
    *c = set_unknown(a.texts, kSetNoEnd);
    return true;
  }
  return false;
}

// Bits of a word below its position b (b clamped to 0..32).
PACK_HD uint32_t bits_below(int64_t b) {
  if (b >= 32) return 0xFFFFFFFFu;
  return b <= 0 ? 0u : (1u << b) - 1u;
}

// 16 bytes at p, 16-byte aligned, as 4 little-endian words (on the card
// through the read-only cache: streaming loads, __ldcs, were slower).
PACK_HD void load16(const uint8_t* p, uint32_t u[4]) {
#if defined(__CUDA_ARCH__)
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  u[0] = v.x;
  u[1] = v.y;
  u[2] = v.z;
  u[3] = v.w;
#else
  std::memcpy(u, p, 16);
#endif
}

// u[i + q] for q in 0..3, without indexing registers by a variable.
PACK_HD uint32_t pick(const uint32_t u[12], int i, int q) {
  return q == 0 ? u[i] : q == 1 ? u[i + 1] : q == 2 ? u[i + 2] : u[i + 3];
}

// Bytes a0 .. a0 + 31 of text as 8 little-endian words, zero where outside
// [lo, hi) (0 <= lo, hi <= len): two aligned 16-byte loads where a0 is
// aligned, three and funnel shifts where it is not, wherever those loads
// lie inside [lo, hi); else a byte at a time. No byte outside [lo, hi) is
// read.
PACK_HD void load_span(const PackSetArgs& a, int64_t a0, int64_t lo,
                       int64_t hi, uint32_t x[8]) {
  const int64_t base = a0 & ~int64_t{15};
  const int sh = static_cast<int>(a0 - base);
  if (a.aligned && base >= lo && base + (sh ? 48 : 32) <= hi) {
#ifdef SASSY_PACK_READ_HOOK
    SASSY_PACK_READ_HOOK(base, sh ? 48 : 32);  // a host build's load check
#endif
    if (sh == 0) {
      load16(a.text + base, x);
      load16(a.text + base + 16, x + 4);
      return;
    }
    uint32_t u[12];
    load16(a.text + base, u);
    load16(a.text + base + 16, u + 4);
    load16(a.text + base + 32, u + 8);
    const int q = sh >> 2;
    const int r = 8 * (sh & 3);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const uint64_t v = (static_cast<uint64_t>(pick(u, m + 1, q)) << 32) |
                         pick(u, m, q);
      x[m] = static_cast<uint32_t>(v >> r);
    }
    return;
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t b = a0 + 4 * m + i;
      if (b >= lo && b < hi) {
#ifdef SASSY_PACK_READ_HOOK
        SASSY_PACK_READ_HOOK(b, 1);
#endif
        v |= static_cast<uint32_t>(a.text[b]) << (8 * i);
      }
    }
    x[m] = v;
  }
}

// The 32 bytes of x in reverse order.
PACK_HD void reverse_bytes(uint32_t x[8]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const uint32_t lo = x[m];
    const uint32_t hi = x[7 - m];
    x[m] = (hi >> 24) | ((hi >> 8) & 0xFF00u) | ((hi << 8) & 0xFF0000u) |
           (hi << 24);
    x[7 - m] = (lo >> 24) | ((lo >> 8) & 0xFF00u) | ((lo << 8) & 0xFF0000u) |
               (lo << 24);
  }
}

// Plane word w of the set, in text c (set_resolve's): its bytes forwards
// or backwards, their planes, the n_t mask and the 'N's, stored in every
// row of out.
PACK_HD void pack_set_word(const PackSetArgs& a, int64_t w, const SetText& c,
                           const uint8_t* codes) {
  uint32_t r[8] = {};
  uint32_t keep = 0u;  // positions < n_t
  uint32_t mark = 0u;  // positions n_t .. n_t + steps - 1
  if (c.t >= 0 && c.t < a.texts) {
    const int64_t n = c.len;
    const int64_t p0 = kWordBytes * (w - c.first);  // the word's position 0
    keep = bits_below(n - p0);
    mark = bits_below(n + a.steps - p0) & ~keep;
    if (keep) {
      const int64_t lo = c.start > 0 ? c.start : 0;
      const int64_t end = c.start + n;
      const int64_t hi = end < a.len ? end : a.len;
      uint32_t x[8];
      load_span(a, a.reverse ? end - p0 - kWordBytes : c.start + p0, lo, hi,
                x);
      if (a.reverse) reverse_bytes(x);
      transpose_word(x, codes, r);
    }
  }
#pragma unroll
  for (int p = 0; p < kPackMaxPlanes; ++p) {
    if (p < a.planes) a.out[p * a.width + w] = (r[p] & keep) | mark;
  }
  if (a.with_valid) a.out[a.planes * a.width + w] = keep | mark;
}

// The set pack's arguments as the C entry points take them, checked: false
// for arguments they refuse. Fills a and the launch's byte-code table.
inline bool pack_set_setup(const void* text, long long len,
                           const long long* starts, const long long* lens,
                           const long long* wofs, long long texts, void* out,
                           long long width, long long steps, int reverse,
                           int planes, int with_valid, int mode, int shift,
                           int mask, const unsigned int* pmasks, int fold,
                           PackSetArgs* a, PackTable* tab) {
  if (width <= 0 || len < 0 || texts < 0 || steps < 0 || planes < 1 ||
      planes > kPackMaxPlanes || out == nullptr ||
      (mode != kPackModeTable5 && mode != kPackModeByte) || shift < 0 ||
      shift > 7 || mask < 0 || mask > 31 ||
      (mode == kPackModeTable5 && pmasks == nullptr) ||
      (len > 0 && text == nullptr) || wofs == nullptr ||
      (texts > 0 && (starts == nullptr || lens == nullptr))) {
    return false;
  }
  uint32_t pm[kPackMaxPlanes] = {};
  if (mode == kPackModeTable5) {
    for (int p = 0; p < planes; ++p) pm[p] = pmasks[p];
  }
  *tab = pack_table(mode, shift, mask, pm, planes, fold != 0);
  a->text = static_cast<const uint8_t*>(text);
  a->len = len;
  a->starts = reinterpret_cast<const int64_t*>(starts);
  a->lens = reinterpret_cast<const int64_t*>(lens);
  a->wofs = reinterpret_cast<const int64_t*>(wofs);
  a->texts = texts;
  a->out = static_cast<uint32_t*>(out);
  a->width = width;
  a->steps = steps;
  a->planes = planes;
  a->with_valid = with_valid != 0;
  a->reverse = reverse != 0;
  a->aligned = reinterpret_cast<uintptr_t>(text) % 16 == 0;
  return true;
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
