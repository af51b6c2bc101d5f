// A host program over sassy_tpu_torch/csrc/select_words.cuh, the grid,
// the per-element work and the state chain of the word-level selection
// kernels (select_words.cu), for tests/test_torch_select.py: built with
// g++ -ffp-contract=off, it runs the kernels' three launches in turn, each
// block and each segment one after another where the kernels run them side
// by side (pass 0: each block's counts for both entering states of its
// segment and each segment's map; pass 1: the segments' entering states,
// the carry out, each block's offset and the total; pass 2: the
// candidates). The same argument list as the kernels' C entry point, on
// host memory.

#include <vector>

#include "select_words.cuh"

namespace {

void count_blocks(const WordArgs& a, const Grid& g, const WordScratch& sc) {
  std::vector<uint8_t> rel(kBlockElems);
  for (int64_t b = 0; b < g.blocks(); ++b) {
    const Part p = part_of(g, b);
    const uint32_t seg_map =
        chain_run(a, p.q, p.t0, p.t1, kIdentity, rel.data(), p.t0);
    int n[2] = {0, 0};
    for (int e = 0; e < p.elems(); ++e) {
      const int64_t f = p.base + e;
      const uint32_t r = needs_state(a, f) ? rel[elem_tile(p, e)] : 0u;
      n[0] += count_at(a, f, r, 0);
      n[1] += count_at(a, f, r, 1);
    }
    sc.counts[b] = pack_counts(n[0], n[1]);
    if (p.w0 == 0) {
      sc.segs[2 * p.seg] = static_cast<int32_t>(a.all_minima ? kIdentity : seg_map);
    }
  }
}

void scan_blocks(const WordArgs& a, const Grid& g, const WordScratch& sc,
                 int32_t* carry_out) {
  uint32_t ex = kIdentity;
  for (int64_t s = 0; s < g.segments(); ++s) {
    const int q = static_cast<int>(s / g.XB);
    const uint32_t m = sc.segs[2 * s];
    const int in = s % g.XB == 0 ? carry_state(a, q) : map_at(ex, 0);
    sc.segs[2 * s + 1] = in;
    ex = map_then(ex, segment_elem(a, g, s, m));
    if (carry_out != nullptr && s % g.XB == g.XB - 1) {
      carry_out[q] = carry_code(a, q, map_at(m, in));
    }
  }
  int64_t off = 0;
  for (int64_t b = 0; b < g.blocks(); ++b) {
    sc.offsets[b] = off;
    off += lane_count(sc.counts[b], sc.segs[2 * part_of(g, b).seg + 1]);
  }
  *sc.total = off;
}

void emit_blocks(const WordArgs& a, const Grid& g, const WordScratch& sc,
                 int64_t* out, int64_t N) {
  std::vector<uint8_t> rel(kBlockElems);
  for (int64_t b = 0; b < g.blocks(); ++b) {
    const Part p = part_of(g, b);
    const int in = sc.segs[2 * p.seg + 1];
    if (lane_count(sc.counts[b], in) == 0) continue;
    chain_run(a, p.q, p.t0, p.t1, kIdentity, rel.data(), p.t0);
    int64_t o = sc.offsets[b];
    for (int e = 0; e < p.elems(); ++e) {
      const int64_t f = p.base + e;
      const bool up =
          needs_state(a, f) && map_at(rel[elem_tile(p, e)], in) != 0;
      o += word_candidates<true>(a, f, up, out, N, o);
    }
  }
}

}  // namespace

extern "C" long long sassy_words_scratch(int Q, int NW, int T) {
  return word_scratch_words(grid_of(Q, NW, T));
}

extern "C" void sassy_words_host(
    const void* vp, const void* vm, const void* cost, const void* meta,
    const void* valid_from, const void* valid_to, const void* islast,
    const void* pos_base, const void* text_end, const void* final,
    const void* is_start, const void* state0, const void* carry,
    void* carry_out, void* scratch, void* out, long long N, int Q, int NW,
    int T, int k, int all_minima, int n_prev, float alpha, int pass) {
  const WordArgs a = word_args(vp, vm, cost, meta, valid_from, valid_to,
                               islast, pos_base, text_end, final, is_start,
                               state0, carry, Q, NW, T, k, all_minima,
                               n_prev, alpha);
  const Grid g = grid_of(Q, NW, T);
  const WordScratch sc = word_scratch_at(scratch, g);
  if (pass == 0) {
    count_blocks(a, g, sc);
  } else if (pass == 1) {
    scan_blocks(a, g, sc, static_cast<int32_t*>(carry_out));
  } else {
    emit_blocks(a, g, sc, static_cast<int64_t*>(out), N);
  }
}
