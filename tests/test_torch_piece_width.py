"""The batched engine's piece width and piece plan at scale, on the CPU.

``batch._piece_width`` keeps a full dispatch chunk at
``plan.H100_TARGET_TILES`` (pattern, piece) threads or more: many patterns
over a long text (the off-target flagship, 312 guides over 3.12 Gbp) get
pieces narrow enough for that, while shapes already under the bound (the
nanopore read set, one pattern) keep their width. ``batch._plan_columns``
cuts the pieces without an object per piece; it equals
``batch._plan_pieces``, which ``tests/test_torch_batch.py`` holds to the
JAX planner. Results never depend on the width: the candidates with the
bound forced small equal those without it and the JAX package's.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from sassy_tpu import Searcher as RefSearcher
from sassy_tpu.ops import batch as ref_batch
from sassy_tpu_torch import Searcher, profiles
from sassy_tpu_torch.ops import batch, plan
from test_torch_batch import REF_PROFILES, _same

OFF_TARGETS_FULL = [3_120_000_000]
NANOPORE_FULL = [10_000] * 33_400
BASES = np.frombuffer(b"ACGT", np.uint8)


def _chunks(lens, steps, halo, Q, pair_bytes):
    """The width, and the dispatch chunks of one group of Q patterns over
    ``lens`` at it (``BatchEngine.chunks`` on the plan's shape)."""
    w_chars = batch._piece_width(lens, steps, halo, Q, pair_bytes)
    T = len(batch._plan_columns(lens, steps, w_chars, halo)["text_idx"])
    g = SimpleNamespace(Q=Q, pair_bytes=pair_bytes)
    pp = SimpleNamespace(NW=w_chars // 32 + 1, T=T)
    return w_chars, list(batch.BatchEngine.chunks(g, pp))


@pytest.mark.parametrize("pair_bytes,nw_max", [(16, 497), (12, 663)])
def test_full_chunks_fill_the_card_at_off_targets_full(pair_bytes, nw_max):
    """312 guides of 23 bp (halo 27) over 3.12 Gbp: pieces of at most
    ~496 words (word level, 16 bytes a pair) or ~662 (position level, 12
    bytes), and every full chunk launches at least H100_TARGET_TILES
    threads, where W_MAX_WORDS pieces gave 105 pieces a launch."""
    w_chars, chunks = _chunks(OFF_TARGETS_FULL, 0, 27, 312, pair_bytes)
    NW = w_chars // 32 + 1
    assert NW <= nw_max
    assert len(chunks) > 1
    for q0, q1, t0, t1 in chunks[:-1]:
        assert (q1 - q0) * (t1 - t0) >= plan.H100_TARGET_TILES
    # the same text with the bound lifted: the widest pieces, few threads
    with pytest.MonkeyPatch.context() as m:
        m.setattr(batch, "DISPATCH_BYTES", 1 << 60)
        wide = batch._piece_width(OFF_TARGETS_FULL, 0, 27, 312, pair_bytes)
    assert wide == batch.W_MAX_WORDS * 32 > w_chars


@pytest.mark.parametrize("lens,halo,Q", [
    (NANOPORE_FULL, 27, 96),           # nanopore_full: 10,240-char pieces
    (OFF_TARGETS_FULL, 27, 1),         # the search column: one guide
    (NANOPORE_FULL, 27, 1),
    ([5_000_000] * 3, 120, 1),
    ([200] * 1000, 27, 8),
])
def test_shapes_under_the_bound_keep_their_width(lens, halo, Q):
    """Where the pieces times the patterns already fill a chunk, the width
    is what it is without the bound."""
    got = batch._piece_width(lens, 0, halo, Q, 16)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(batch, "DISPATCH_BYTES", 1 << 60)
        assert got == batch._piece_width(lens, 0, halo, Q, 16)
    if lens is NANOPORE_FULL and Q == 96:
        assert got == 10_240


def _loop_columns(lens, steps, w_chars, halo):
    pieces = batch._plan_pieces(lens, steps, w_chars, halo)
    return {f: np.array([int(getattr(p, f)) for p in pieces], np.int64)
            for f in batch.PIECE_FIELDS}


@pytest.mark.parametrize("seed", range(6))
def test_plan_columns_equal_the_loop(seed):
    """The vectorised cut equals the per-piece loop: texts of one piece,
    long texts cut in runs, empty texts, overhang steps that split the
    overshoot span, halos that are and are not whole words."""
    rng = np.random.default_rng(seed)
    lens = ([0, 1, 31, 32, 33] + rng.integers(0, 6000, 12).tolist()
            + [int(rng.integers(20_000, 90_000))])
    rng.shuffle(lens)
    for halo in (9, 27, 64, 75, 140):
        for steps in (0, 1, 7, 32, 33, 101, 300):
            for w_words in (8, 16, 40, 64, 320):
                w_chars = w_words * 32
                if w_chars <= halo + 32:
                    continue
                want = _loop_columns(lens, steps, w_chars, halo)
                got = batch._plan_columns(lens, steps, w_chars, halo)
                for f in batch.PIECE_FIELDS:
                    np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert all(len(v) == 0 for v in batch._plan_columns([], 0, 512, 27)
               .values())


def test_plan_columns_equal_the_reference_planner_at_scale():
    """One 3 Mbp text and many short ones: the JAX planner's pieces."""
    lens = [3_000_000] + [700] * 50 + [15_000]
    got = batch._plan_columns(lens, 0, 448 * 32, 27)
    want = ref_batch._plan_pieces(lens, 0, 448 * 32, 27)
    assert len(got["text_idx"]) == len(want)
    for f in batch.PIECE_FIELDS:
        np.testing.assert_array_equal(
            got[f], [int(getattr(p, f)) for p in want], err_msg=f)


def _equal_the_reference(lens, steps, w_chars, halo):
    got = batch._plan_columns(lens, steps, w_chars, halo)
    want = ref_batch._plan_pieces(lens, steps, w_chars, halo)
    assert len(got["text_idx"]) == len(want)
    for f in batch.PIECE_FIELDS:
        np.testing.assert_array_equal(
            got[f], [int(getattr(p, f)) for p in want], err_msg=f)
    return got


@pytest.mark.parametrize("steps", [0, 7, 33])
@pytest.mark.parametrize("m", [24, 120])
def test_plan_columns_equal_the_reference_planner_at_many_texts(m, steps):
    """3,200 texts of 8-12 kbp, as the CLI's groups hold them, at the
    halo of an m bp pattern at k = 3 and the widths a 64- and a
    32-pattern batch get (pieces narrower than a text): the JAX planner's
    pieces, every field, the overshoot split included."""
    rng = np.random.default_rng(m + steps)
    lens = rng.integers(8_000, 12_001, 3_200).tolist()
    codes = profiles.Dna().encode(rng.choice(BASES, m))
    halo = plan.pattern_inputs_np(profiles.Dna(), codes, None, None)[0] \
        .shape[0] + 3
    for Q in (64, 32):
        w_chars = batch._piece_width(lens, steps, halo, Q, 16)
        assert w_chars < 8_000
        got = _equal_the_reference(lens, steps, w_chars, halo)
        assert np.all(np.bincount(got["text_idx"]) > 1)


@pytest.mark.parametrize("steps", [0, 5, 33])
@pytest.mark.parametrize("halo", [27, 64, 75])
def test_plan_columns_where_runs_end_at_the_split_or_the_text_end(halo,
                                                                  steps):
    """Many texts whose run of regular pieces ends exactly at the
    overshoot split n or at the last position (total - 1), and one
    position either side, beside empty texts and texts just over one
    piece: the JAX planner's pieces."""
    w_chars = 12 * 32
    stride = w_chars - -(-halo // 32) * 32
    lens = [0, 1, w_chars - steps, w_chars - steps + 1, w_chars + 1]
    for runs in range(1, 12):
        end = w_chars + runs * stride
        for d in (-1, 0, 1):
            lens.append(end + d)  # a run to n
            lens.append(end + 1 - steps + d)  # a run to total - 1
    lens = [max(0, n) for n in lens] * 3
    got = _equal_the_reference(lens, steps, w_chars, halo)
    want = _loop_columns(lens, steps, w_chars, halo)
    for f in batch.PIECE_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _narrowed(monkeypatch, pair_words: int):
    """Wide pieces (few tiles fill the card), then a dispatch budget that
    caps them at about ``pair_words`` window words."""
    monkeypatch.setattr(plan, "H100_TARGET_TILES", 8)
    monkeypatch.setattr(batch, "DISPATCH_BYTES", 16 * 8 * pair_words)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("all_minima", [False, True])
def test_candidates_at_a_capped_width_equal_reference(reverse, all_minima,
                                                      monkeypatch):
    """Three patterns over long texts: the width the dispatch bound forces
    is narrower than the one without it, and both give the JAX
    BatchEngine's candidates, on either strand."""
    prof = profiles.Dna()
    rng = np.random.default_rng(int(reverse) + 2 * int(all_minima))
    pats = [rng.choice(BASES, 20) for _ in range(3)]
    texts = [rng.choice(BASES, n) for n in (9_000, 14_000, 300)]
    for i, t in enumerate(texts[:2]):  # a copy for either strand's scan
        t[4000:4020] = pats[i]
        t[4010] = ord("A") if t[4010] != ord("A") else ord("C")
        t[7000:7020] = pats[i][::-1]
    codes = [prof.encode(p) for p in pats]
    monkeypatch.setattr(plan, "H100_TARGET_TILES", 8)
    eng = batch.BatchEngine("cpu")
    ts = batch.TextSet(texts, "cpu")
    (wide,) = eng.groups(prof, codes, ts, 3)
    whole = eng.candidates_many(prof, codes, texts, 3, None, None,
                                all_minima, reverse)
    _narrowed(monkeypatch, 17)
    (narrow,) = eng.groups(prof, codes, ts, 3)
    assert narrow.w_chars < wide.w_chars
    got = eng.candidates_many(prof, codes, texts, 3, None, None, all_minima,
                              reverse)
    assert got == whole
    want = ref_batch.BatchEngine(backend="xla").candidates_many(
        REF_PROFILES["dna"], codes, texts, 3, all_minima=all_minima,
        reverse=reverse)
    assert got == want
    assert sum(len(c) for row in got for c in row)


@pytest.mark.parametrize("alpha,m,k", [(0.5, 24, 3), (0.1, 110, 10)])
def test_overhang_at_a_capped_width_equals_reference(alpha, m, k,
                                                     monkeypatch):
    """Overhang at the word level (a short overshoot) and the position
    level (12 bytes a pair): the capped width gives the uncapped Match
    lists and the numpy oracle's, both strands."""
    rng = np.random.default_rng(m)
    pats = [rng.choice(BASES, m) for _ in range(2)]
    texts = [rng.choice(BASES, n) for n in (6_000, 7_500)]
    texts[0][: m - 4] = pats[0][4:]
    texts[1][-(m - 4):] = pats[1][: m - 4]
    texts[1][3000 : 3000 + m] = pats[0]
    monkeypatch.setattr(plan, "H100_TARGET_TILES", 8)
    port = Searcher("iupac", rc=True, alpha=alpha, device="cpu")
    ts = batch.TextSet(texts, "cpu")
    codes = [profiles.Iupac().encode(p) for p in pats]
    (wide,) = batch.BatchEngine("cpu").groups(profiles.Iupac(), codes, ts, k,
                                             alpha)
    whole = port.search_many(pats, texts, k)
    _narrowed(monkeypatch, 17)
    (narrow,) = batch.BatchEngine("cpu").groups(profiles.Iupac(), codes, ts,
                                               k, alpha)
    assert narrow.w_chars < wide.w_chars
    got = port.search_many(pats, texts, k)
    _same(got, whole)
    _same(got, RefSearcher("iupac", rc=True, alpha=alpha,
                           engine="numpy").search_many(pats, texts, k))
    assert got
