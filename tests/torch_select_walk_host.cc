// A host program over sassy_tpu_torch/csrc/select_walk.cuh, the walk of the
// position-level selection kernels (select_positions.cu), for
// tests/test_torch_select.py: built with g++ -ffp-contract=off, it runs
// each tile's walk as the kernels' first launch does (sassy_walk_*,
// pass 0: the tile records) and, given each tile's entering state and
// output offset from the records composed in tile order, as their last
// launch does (pass 1: the candidates). The same argument lists as the
// kernels' C entry points, on host memory.

#include "select_walk.cuh"

namespace {

template <class Args>
void walk_items(const Args& a, int64_t items, int pass, TileRec* recs,
                const int32_t* enter, const int64_t* offsets, int64_t* out,
                long long N) {
  for (int64_t i = 0; i < items; ++i) {
    if (pass == 0) {
      recs[i] = record_of(a, i);
    } else if (recs[i].n[enter[i]] != 0) {
      emit_item(a, i, recs[i], enter[i], out, N, offsets[i]);
    }
  }
}

}  // namespace

extern "C" void sassy_walk_text(
    const void* vp, const void* vm, const void* cost, long long sw,
    long long boundary_m, long long n_text, long long max_pos,
    long long min_pos, long long owned_end, int T, int W, int halo, int k,
    int all_minima, int gated, int seed, float alpha, int pass,
    TileRec* recs, const int32_t* enter, const int64_t* offsets,
    int64_t* out, long long N) {
  const TextArgs a = text_args(vp, vm, cost, sw, boundary_m, n_text, max_pos,
                               min_pos, owned_end, T, W, halo, k, all_minima,
                               gated, seed, alpha);
  walk_items(a, T, pass, recs, enter, offsets, out, N);
}

extern "C" void sassy_walk_pieces(
    const void* vp, const void* vm, const void* cost, const void* boundary0,
    const void* text_end, const void* valid_from, const void* valid_to,
    const void* islast, const void* pos_base, const void* state0,
    const void* is_start, const void* carry, long long sq, long long sw,
    int Q, int NW, int T, int k, int all_minima, float alpha, int pass,
    TileRec* recs, const int32_t* enter, const int64_t* offsets,
    int64_t* out, long long N) {
  const PieceArgs a = piece_args(vp, vm, cost, boundary0, text_end, valid_from,
                                 valid_to, islast, pos_base, state0, is_start,
                                 carry, sq, sw, Q, NW, T, k, all_minima, alpha);
  walk_items(a, static_cast<int64_t>(Q) * T, pass, recs, enter, offsets, out,
             N);
}
