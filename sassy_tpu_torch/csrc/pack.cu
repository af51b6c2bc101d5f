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

//
// The text set's pack (pack_set_words, entry sassy_pack_set): the planes
// of the batched engine's whole text set, in their final layout, from the
// texts' bytes as uploaded (one buffer, each text once, no gaps). Replaces
// what the JAX pipeline does around its pack for a text set: the host
// copies of the reversed texts (_texts_for, sassy_tpu/ops/batch.py:119)
// and the device's reverse_planes (sassy_tpu/ops/myers_xla.py:228) for
// the reverse strand, and the overshoot's overhang_pad_code of the host
// packing (_pack_pieces_np, batch.py:436). Per plane word: its text, its
// 32 bytes read forwards or backwards (a reversed word is a
// byte-reversed span of the forward bytes), the planes as above, the
// text's n mask and its steps 'N' positions. No byte outside the word's
// text is read. The single engine's reverse strand is this kernel on a
// one-text set (starts [0], lens [n], wofs [0, ceil(n / 32)]) over the
// forward bytes, which the forward strand's pack reads from the same
// upload.
//
// What bounds it: bytes, as the one-text pack: each byte read once, each
// plane word written once (and the tables, 24 bytes a text); pack_bound
// at 3.12 GB of DNA and its 4 planes is ~1.4 ms a strand, at 334 MB
// ~0.15 ms. What the design does about it: one launch a strand, as many
// blocks as the card holds at once, each warp one contiguous range of
// plane words, 32 side by side, so a warp writes 128 adjacent bytes of
// each plane and reads 1 KiB of adjacent text (in either direction) a
// step. A word's text costs O(1) table reads amortised (pack.cuh,
// SetText / SetStage): a lane keeps its text's entry until its words
// pass that text's end, and then the warp stages the next 32 texts' entries
// in shared memory with one load a lane and each lane finds its own there;
// a range's first text comes from one search of the table, 32 probes a
// round. Each thread reads its 32 bytes with two 16-byte loads through
// the read-only cache (streaming loads were 4-8% slower at one text), or
// three and funnel shifts where the span is not aligned (the third load
// is the next thread's first: L1), wherever they lie inside the text,
// and a byte at a time only at a text's ends. 55 registers, four blocks
// an SM: capping them at 40 or 32 (__launch_bounds__) spilled and was
// 8-46% slower. It replaces the
// port's PyTorch composition of a host buffer, a reverse gather, the end
// masking and a regather of every plane word for the overshoot.

#include "pack.cuh"

namespace {

constexpr int kPackThreads = 256;
constexpr int kPackBlocksPerSm = 8;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

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

__global__ void __launch_bounds__(kPackThreads)
pack_set_words(PackSetArgs a, PackTable tab, int64_t per_warp) {
  __shared__ uint32_t table[64];
  __shared__ SetStage stages[kPackThreads / kSetLanes];
  if (threadIdx.x < 64) table[threadIdx.x] = tab.words[threadIdx.x];
  __syncthreads();
  const uint8_t* codes = reinterpret_cast<const uint8_t*>(table);
  const int lane = threadIdx.x % kSetLanes;
  SetStage* s = &stages[threadIdx.x / kSetLanes];
  const int64_t w_begin =
      (static_cast<int64_t>(blockIdx.x) * kPackThreads + threadIdx.x) /
      kSetLanes * per_warp;
  const int64_t w_end =
      w_begin + per_warp < a.width ? w_begin + per_warp : a.width;
  if (w_begin >= w_end) return;  // the whole warp
  // the text of the range's first word: 32 probes a round
  int64_t lo = -1;
  int64_t hi = a.texts;
  while (lo < hi) {
    const unsigned below =
        __ballot_sync(kAllLanes, a.wofs[set_probe(lo, hi, lane)] <= w_begin);
    set_narrow(&lo, &hi, __popc(below));
  }
  SetText c = set_unknown(lo, w_begin);
  for (int64_t w0 = w_begin; w0 < w_end; w0 += kSetLanes) {
    const int64_t w = w0 + lane;
    bool open = w >= c.end;  // the lane passed its text
    if (__any_sync(kAllLanes, open)) {
      const int64_t last = __shfl_sync(kAllLanes, c.t, kSetLanes - 1);
      int64_t base = last > 0 ? last : 0;
      do {
        set_stage(a, base, lane, s);
        __syncwarp();
        if (open) open = !set_resolve(a, *s, base, w, &c);
        __syncwarp();
        base += kSetLanes;
      } while (__any_sync(kAllLanes, open));
    }
    if (w < w_end) pack_set_word(a, w, c, codes);
  }
}

// Blocks of a launch over `words` words: enough for one word a thread, at
// most per_sm a streaming multiprocessor.
cudaError_t pack_blocks(long long words, int per_sm, unsigned* blocks) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long need = (words + kPackThreads - 1) / kPackThreads;
  const long long most = static_cast<long long>(sms) * per_sm;
  *blocks = static_cast<unsigned>(need < most ? need : most);
  return err;
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
  unsigned blocks = 0;
  const cudaError_t err = pack_blocks(gw, kPackBlocksPerSm, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = reinterpret_cast<uintptr_t>(text) % 16 == 0;
  pack_words<<<blocks, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, tab, aligned);
  return static_cast<int>(cudaGetLastError());
}

// Pack a text set: `texts` texts in `text` (len bytes), text t's lens[t]
// bytes from byte starts[t], its words from wofs[t] (wofs holds texts + 1
// entries, the last the total), read backwards with `reverse`, each
// followed by `steps` 'N' positions, into `out` ((planes + with_valid,
// width) uint32, zero from word wofs[texts] on); the three tables are
// int64 on the device. Launches one kernel on `stream` without
// synchronising; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int sassy_pack_set(const void* text, long long len,
                              const long long* starts, const long long* lens,
                              const long long* wofs, long long texts,
                              void* out, long long width, long long steps,
                              int reverse, int planes, int with_valid,
                              int mode, int shift, int mask,
                              const unsigned int* pmasks, int fold,
                              void* stream) {
  PackSetArgs a;
  PackTable tab;
  if (!pack_set_setup(text, len, starts, lens, wofs, texts, out, width,
                      steps, reverse, planes, with_valid, mode, shift, mask,
                      pmasks, fold, &a, &tab)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // as many blocks as the card holds at once: each warp packs one range,
  // so a block left waiting for a slot would add its range's time
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pack_set_words, kPackThreads, 0);
  unsigned blocks = 0;
  if (err == cudaSuccess) err = pack_blocks(width, per_sm, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t per_warp =
      set_warp_words(width, static_cast<int64_t>(blocks) * kPackThreads /
                                kSetLanes);
  pack_set_words<<<blocks, kPackThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a, tab, per_warp);
  return static_cast<int>(cudaGetLastError());
}
