// The text pack for Hopper (sm_90a): a text's bytes -> the (P[+1], GW)
// bit-planes of the engine codes that every scan reads.
//
// Replaces the XLA pack that the JAX pipeline runs on the device before
// its scan kernels: the jitted pack of sassy_tpu/ops/myers_xla.py:172
// (pack_jit, :950; _pack_planes, :1123). It computes what the port's
// plain version computes (myers_torch.pack_plain), bit for bit: plane p's
// word w has bit i = bit p of the code of the byte at position 32 w + i,
// the code from the profile's pack descriptor ("table5": bit
// ((b >> shift) & mask) of pmasks[p]; "byte": the byte, lowercased with
// fold); positions >= n = 32 nw + nb are zero in every plane; the
// optional validity plane marks the positions < n. The per-word code is
// in pack.cuh.
//
// What bounds it on the H100: bytes. Each byte is read once and each
// plane word written once: for 1 GiB of DNA or IUPAC text (4 planes) 1.5
// GiB, ~0.48 ms at 3.35 TB/s; for ascii (8 planes and validity) 2.125 GiB.
// The plain version expands every byte to int32 and makes a pass per plane
// over it (~105 ms a GiB on the card).
//
// What the design does about it: one launch, one thread a word, each
// block walking words a grid apart, so a warp reads 1 KiB of adjacent text
// in two 16-byte loads a thread and writes 128 adjacent bytes of each
// plane. The byte codes are one 256-entry table, built once a launch on
// the host from the descriptor and copied to shared memory by each block;
// a word's planes come from 32 table reads and about a hundred 32-bit
// operations (pack.cuh's transpose_word), no per-byte branch and no
// per-plane pass. Positions and offsets are 64-bit (3.12 Gbp text sets,
// sharded texts past 2^31). No byte at or past n, or past the input's
// end, is read: the word that holds n, and any word of an input not
// 16-byte aligned, is read a byte at a time.

#include "pack.cuh"

namespace {

constexpr int kPackThreads = 256;
constexpr int kPackBlocksPerSm = 8;

__global__ void __launch_bounds__(kPackThreads)
pack_words(PackArgs a, PackTable tab, bool aligned) {
  __shared__ uint32_t table[64];
  if (threadIdx.x < 64) table[threadIdx.x] = tab.words[threadIdx.x];
  __syncthreads();
  const uint8_t* codes = reinterpret_cast<const uint8_t*>(table);
  const int64_t lim = pack_limit(a);
  const int64_t step = static_cast<int64_t>(gridDim.x) * kPackThreads;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kPackThreads +
                   threadIdx.x;
       j < a.gw; j += step) {
    const uint32_t nmask = n_mask(a, j);
    const int64_t b0 = kWordBytes * j;
    uint32_t r[8];
    if (b0 >= lim) {  // every position past n
#pragma unroll
      for (int p = 0; p < 8; ++p) r[p] = 0u;
    } else {
      uint32_t x[8];
      if (aligned && b0 + kWordBytes <= lim) {
        const uint4* q = reinterpret_cast<const uint4*>(a.text + b0);
        const uint4 u = __ldcs(q);
        const uint4 v = __ldcs(q + 1);
        x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
        x[4] = v.x; x[5] = v.y; x[6] = v.z; x[7] = v.w;
      } else {
        load_word_bytes(a, j, lim, x);
      }
      transpose_word(x, codes, r);
    }
    store_word(a, j, r, nmask);
  }
}

}  // namespace

// Pack gw words of text (len readable bytes at `text`, position
// 32 * word0 first) into `out` ((planes + with_valid, gw) uint32, word
// word0 first); pmasks holds `planes` words (table5). Launches one kernel
// on `stream` without synchronising; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int sassy_pack(const void* text, long long len, void* out,
                          long long gw, long long word0, long long nw,
                          int nb, int planes, int with_valid, int mode,
                          int shift, int mask, const unsigned int* pmasks,
                          int fold, void* stream) {
  if (gw <= 0 || len < 0 || word0 < 0 || nw < 0 || nb < 0 || nb >= 32 ||
      planes < 1 || planes > kPackMaxPlanes || out == nullptr ||
      (mode != kPackModeTable5 && mode != kPackModeByte) || shift < 0 ||
      shift > 7 || mask < 0 || mask > 31 ||
      (mode == kPackModeTable5 && pmasks == nullptr) ||
      (len > 0 && text == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
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
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (gw + kPackThreads - 1) / kPackThreads;
  const long long most = static_cast<long long>(sms) * kPackBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(need < most ? need : most);
  const bool aligned = reinterpret_cast<uintptr_t>(text) % 16 == 0;
  pack_words<<<blocks, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, tab, aligned);
  return static_cast<int>(cudaGetLastError());
}
