"""Overhang on the port's batched engine: the piece planner and the piece
windows with overshoot steps against the JAX package's, ``BatchEngine``
against the reference's XLA batched engine, and the port's
``Searcher(..., alpha=..., device="cpu")`` batched entry points against
the reference's ``engine="xla"`` and ``engine="numpy"``, Match for Match
with CIGAR, both strands: the word-level path (q2meta's plain version)
and the position-level path (q2's), unequal pattern lengths, and dispatch
chunks that change no result."""

import numpy as np
import pytest

from sassy_tpu import Searcher as RefSearcher
from sassy_tpu import profiles as ref_profiles
from sassy_tpu.ops import batch as ref_batch
from sassy_tpu_torch import Searcher, profiles, semantics
from sassy_tpu_torch.ops import batch, minima, myers_cuda
from test_torch_cuda import _key, _same

BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = np.zeros(256, np.uint8)
COMP[list(b"ACGT")] = list(b"TGCA")
ALPHAS = [0.0, 0.1, 0.25, 0.5, 1.0]
#: (m, k) per alpha: a word-level group (n_prev <= 4) and a position-level
#: one (n_prev >= 5)
WORD_LEVEL = {0.0: (20, 2), 0.1: (24, 3), 0.25: (24, 3), 0.5: (24, 3),
              1.0: (24, 3)}
POSITION_LEVEL = {0.0: (104, 4), 0.1: (104, 10), 0.25: (104, 25),
                  0.5: (104, 48), 1.0: (104, 96)}


def _reads(seed, pats, count, lo, hi, every=1, hang=3):
    """Random reads; every ``every``-th read holds a copy of a pattern
    hanging ``hang`` chars off its start or its end, on either strand."""
    rng = np.random.default_rng(seed)
    reads = [rng.choice(BASES, int(n)) for n in rng.integers(lo, hi, count)]
    for i in range(0, count, every):
        p = pats[(i // every) % len(pats)]
        if (i // every) % 3 == 2:
            p = COMP[p[::-1]]
        m, r = len(p), reads[i]
        if len(r) < 2 * m:
            continue
        if (i // every) % 2:
            r[: m - hang] = p[hang:]
        else:
            r[len(r) - (m - hang) :] = p[: m - hang]
    return reads


def _n_prev(m, k, alpha):
    return -(-semantics.overhang_steps(m, k, alpha, None) // 32) + 1


@pytest.mark.parametrize("steps", [1, 7, 40, 101])
def test_planner_with_steps_equals_reference(steps):
    rng = np.random.default_rng(steps)
    lens = [0, 1, 31, 32, 33] + rng.integers(0, 20000, 30).tolist()
    for halo in (9, 27, 140):
        for w_cap in (16, 64, 320, 8192):
            assert batch._pick_w_words(lens, steps, halo, w_cap) == \
                ref_batch._pick_w_words(lens, steps, halo, w_cap, 1)
        for w_words in (8, 40, 320):
            w_chars = w_words * 32
            if w_chars <= halo + 32:
                continue
            got = batch._plan_pieces(lens, steps, w_chars, halo)
            want = ref_batch._plan_pieces(lens, steps, w_chars, halo)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert vars(a) == {f: getattr(b, f) for f in vars(a)}


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("steps", [7, 101])
def test_piece_windows_with_overshoot_equal_reference(steps, reverse):
    """The device planes regathered with each text's overshoot 'N's (the
    reverse strand's too) equal the JAX package's host packing with
    ``overhang_pad_code``, bit for bit."""
    prof = profiles.Iupac()
    rng = np.random.default_rng(steps + reverse)
    texts = [rng.choice(np.frombuffer(b"ACGTNRY", np.uint8), int(n))
             for n in rng.integers(0, 900, 9)] + [np.zeros(0, np.uint8)]
    texts[2] = texts[2][:1]
    ts = batch.TextSet(texts, "cpu")
    halo, w_chars = 27, 256
    pp = ts.piece_plan(halo, w_chars, steps)
    pieces = ref_batch._plan_pieces(ts.lens, steps, w_chars, halo)
    want = ref_batch._pack_pieces_np(
        ref_profiles.Iupac(), ref_batch.TextSet(texts)._texts_for(reverse),
        pieces, w_chars, steps,
    ).transpose(2, 0, 1).view(np.int32)
    assert pp.T == len(pieces) and pp.NW == want.shape[0]
    np.testing.assert_array_equal(
        ts.windows(prof, pp, reverse, 0, pp.T).numpy(), want)
    assert pp.text_end.tolist() == [p.text_end for p in pieces]
    # the planes without overshoot are still those of steps 0
    pp0 = ts.piece_plan(halo, w_chars)
    want0 = ref_batch._pack_pieces_np(
        ref_profiles.Iupac(), ref_batch.TextSet(texts)._texts_for(reverse),
        ref_batch._plan_pieces(ts.lens, 0, w_chars, halo), w_chars, 0,
    ).transpose(2, 0, 1).view(np.int32)
    np.testing.assert_array_equal(
        ts.windows(prof, pp0, reverse, 0, pp0.T).numpy(), want0)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("path", ["word", "position"])
@pytest.mark.parametrize("all_minima", [False, True])
def test_candidates_many_equals_reference_engine(path, reverse, all_minima):
    """``BatchEngine.candidates_many`` with overhang against the
    reference's XLA batched engine, cell for cell."""
    alpha = 0.5 if path == "word" else 0.1
    m, k = WORD_LEVEL[alpha] if path == "word" else POSITION_LEVEL[alpha]
    rng = np.random.default_rng(m)
    pats = [rng.choice(BASES, m) for _ in range(3)]
    texts = _reads(m + 1, pats, 7, 50, 900)
    prof = profiles.Iupac()
    # the reverse strand scans the complemented patterns, as Searcher does
    codes = [prof.encode(COMP[p] if reverse else p) for p in pats]
    kw = dict(all_minima=all_minima, reverse=reverse)
    got = batch.BatchEngine("cpu").candidates_many(prof, codes, texts, k,
                                                   alpha, None, **kw)
    want = ref_batch.BatchEngine(backend="xla").candidates_many(
        ref_profiles.Iupac(), codes, texts, k, alpha, None, **kw)
    assert got == [[list(c) if c else () for c in row] for row in want] \
        or got == want
    assert any(c for row in got for c in row)


@pytest.mark.parametrize("engine", ["numpy", "xla"])
@pytest.mark.parametrize("rc", [False, True])
def test_search_many_shape_of_test_batch_equals_reference(rc, engine):
    """tests/test_batch.py's search_many shape at alpha 0.5: 4 x 12 bp
    patterns over 5 texts of 50-400 chars, copies planted at the ends."""
    rng = np.random.default_rng(52 + int(rc))
    texts = [rng.choice(BASES, int(n)) for n in rng.integers(50, 400, 5)]
    pats = [bytes(rng.choice(BASES, 12)) for _ in range(4)]
    texts[0] = np.concatenate([np.frombuffer(pats[0], np.uint8), texts[0]])
    texts[2] = np.concatenate([texts[2], np.frombuffer(pats[3], np.uint8)])
    texts[4] = np.concatenate([np.frombuffer(pats[1][4:], np.uint8),
                               texts[4], np.frombuffer(pats[2][:9], np.uint8)])
    got = Searcher("iupac", rc=rc, alpha=0.5, device="cpu").search_many(
        pats, texts, 2)
    _same(got, RefSearcher("iupac", rc=rc, alpha=0.5,
                           engine=engine).search_many(pats, texts, 2))
    assert any(m.text_start == 0 for m in got)


@pytest.mark.parametrize("engine", ["numpy", "xla"])
def test_search_all_texts_with_overhang_equals_reference(engine):
    """tests/test_batch.py's all-minima overhang shape: alpha 0.25, k=4."""
    rng = np.random.default_rng(17)
    texts = [rng.choice(BASES, int(n)) for n in rng.integers(20, 60, 3)]
    pats = [bytes(rng.choice(BASES, 10)) for _ in range(2)]
    port = Searcher("iupac", rc=True, alpha=0.25, device="cpu")
    ref = RefSearcher("iupac", rc=True, alpha=0.25, engine=engine)
    for pat in pats:
        got = port.search_all_texts(pat, texts, 4)
        _same(got, ref.search_all_texts(pat, texts, 4))
        assert got


@pytest.mark.parametrize("path", ["word", "position"])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_batched_overhang_equals_oracle(alpha, path):
    """search_many and search_many_with_fn(all_minima) on both strands,
    reads with copies hanging off their ends, against the numpy oracle."""
    m, k = WORD_LEVEL[alpha] if path == "word" else POSITION_LEVEL[alpha]
    assert (_n_prev(m, k, alpha) <= 4) == (path == "word")
    rng = np.random.default_rng(int(alpha * 100) + m)
    pats = [rng.choice(BASES, m) for _ in range(2)]
    texts = _reads(m + 3, pats, 6, 40, 400 if path == "word" else 300,
                   hang=2 if alpha == 1.0 else 3)
    port = Searcher("iupac", rc=True, alpha=alpha, device="cpu")
    ref = RefSearcher("iupac", rc=True, alpha=alpha, engine="numpy")
    got = port.search_many(pats, texts, k)
    _same(got, ref.search_many(pats, texts, k))
    assert any(mt.text_start == 0 for mt in got)
    if k < 40:
        keep = lambda q, t, strand: len(t) % 3 != 1  # noqa: E731
        _same(port.search_many_with_fn(pats, texts, k, True, keep),
              ref.search_many_with_fn(pats, texts, k, True, keep))


@pytest.mark.parametrize("path", ["word", "position"])
def test_batched_overhang_equals_xla_engine(path):
    alpha = 0.5 if path == "word" else 0.1
    m, k = WORD_LEVEL[alpha] if path == "word" else POSITION_LEVEL[alpha]
    rng = np.random.default_rng(m + 11)
    pats = [rng.choice(BASES, m) for _ in range(3)]
    texts = _reads(m, pats, 8, 30, 700)
    got = Searcher("iupac", rc=True, alpha=alpha, device="cpu").search_many(
        pats, texts, k)
    _same(got, RefSearcher("iupac", rc=True, alpha=alpha,
                           engine="xla").search_many(pats, texts, k))
    assert got


@pytest.mark.parametrize("alpha,lens,k", [
    (0.5, (20, 24, 31, 24), 3),  # one row bucket, steps 7 for every length
    (0.0, (20, 24, 31), 2),  # steps = m: a group per length
    (0.1, (24, 104), 10),  # a word-level and a position-level group
])
def test_unequal_lengths_with_overhang(alpha, lens, k):
    """The reference's batched engine refuses unequal lengths with alpha
    and its Searcher falls back to a pairwise loop; the port groups the
    patterns by row bucket and overhang steps and batches each group. Same
    Match lists as the reference's pairwise loop and the oracle."""
    rng = np.random.default_rng(sum(lens))
    pats = [rng.choice(BASES, m) for m in lens]
    texts = _reads(k, pats, 8, 60, 500)
    prof = profiles.Iupac()
    groups = batch.BatchEngine("cpu").groups(
        prof, [prof.encode(p) for p in pats], batch.TextSet(texts), k, alpha)
    want_groups = {(-(-m // 8) * 8, semantics.overhang_steps(m, k, alpha, None))
                   for m in lens}
    assert len(groups) == len(want_groups)
    got = Searcher("iupac", rc=True, alpha=alpha, device="cpu").search_many(
        pats, texts, k)
    for engine in ("xla", "numpy"):
        _same(got, RefSearcher("iupac", rc=True, alpha=alpha,
                               engine=engine).search_many(pats, texts, k))
    assert {m.pattern_idx for m in got} == set(range(len(lens)))


@pytest.mark.parametrize("path", ["word", "position"])
def test_dispatch_chunks_change_no_result(path, monkeypatch):
    """Narrow pieces (texts cut into halo-overlapped segments) and
    dispatch chunks of a few (pattern, piece) pairs give the whole run's
    results: the decreasing state is carried across tile chunks, and on
    the position-level path across the selection's tile sub-ranges of one
    chunk."""
    alpha = 0.5 if path == "word" else 0.0
    m, k = WORD_LEVEL[alpha] if path == "word" else POSITION_LEVEL[alpha]
    rng = np.random.default_rng(7)
    pats = [rng.choice(BASES, m) for _ in range(3)]
    texts = _reads(8, pats, 5, 600, 1400)
    port = Searcher("iupac", rc=True, alpha=alpha, device="cpu")
    whole = port.search_many(pats, texts, k)
    monkeypatch.setattr(batch, "W_MAX_WORDS", 16)
    cut = port.search_many(pats, texts, k)
    if path == "word":
        monkeypatch.setattr(batch, "DISPATCH_BYTES", 16 * 17 * 3)
    else:
        monkeypatch.setattr(batch, "DISPATCH_BYTES", 12 * 17 * 6)
        monkeypatch.setattr(minima, "POSITIONS_PER_CHUNK", 3000)
    ts = batch.TextSet(texts)
    (g,) = batch.BatchEngine("cpu").groups(
        profiles.Iupac(), [profiles.Iupac().encode(p) for p in pats], ts, k,
        alpha)
    pp = ts.piece_plan(g.halo, g.w_chars, g.steps)
    chunks = list(batch.BatchEngine.chunks(g, pp))
    ranges = [r for q0, q1, t0, t1 in chunks
              for r in batch.BatchEngine.select_ranges(g, pp, q1 - q0, t0, t1)]
    assert len(chunks) > 4
    assert len(ranges) > len(chunks) if path == "position" else (
        len(ranges) == len(chunks))
    _same(port.search_many(pats, texts, k), whole)
    _same(cut, whole)
    _same(whole, RefSearcher("iupac", rc=True, alpha=alpha,
                             engine="numpy").search_many(pats, texts, k))


def test_async_entry_point_with_overhang():
    rng = np.random.default_rng(9)
    pats = [rng.choice(BASES, 24) for _ in range(2)]
    texts = _reads(9, pats, 6, 100, 500)
    port = Searcher("iupac", rc=True, alpha=0.5, device="cpu")
    keep = lambda q, t, strand: True  # noqa: E731
    fin = port.search_many_with_fn_async(pats, texts, 3, False, keep)
    got = fin()
    _same(got, port.search_many_with_fn(pats, texts, 3, False, keep))
    _same(got, RefSearcher("iupac", rc=True, alpha=0.5,
                           engine="numpy").search_many(pats, texts, 3))


@pytest.mark.parametrize("path", ["word", "position"])
def test_batched_overhang_equals_single_engine(path):
    """search_many against the port's own per-pair search."""
    alpha = 0.25
    m, k = WORD_LEVEL[alpha] if path == "word" else POSITION_LEVEL[alpha]
    rng = np.random.default_rng(m + 5)
    pats = [rng.choice(BASES, m) for _ in range(2)]
    texts = _reads(m + 5, pats, 4, 200, 500)
    port = Searcher("iupac", rc=True, alpha=alpha, device="cpu")
    single = []
    for qi, p in enumerate(pats):
        for ti, t in enumerate(texts):
            for mt in port.search(p, t, k):
                mt.pattern_idx, mt.text_idx = qi, ti
                single.append(mt)
    _same(sorted(port.search_many(pats, texts, k), key=_key),
          sorted(single, key=_key))


@pytest.mark.parametrize("path", ["word", "position"])
def test_each_path_runs_its_kernel(path, monkeypatch):
    """A word-level group runs q2meta (its plain version here) and never
    q2; a position-level group runs q2 and never q2meta."""
    calls = {"scan_q": 0, "scan_q_meta": 0}
    for name in calls:
        fn = getattr(myers_cuda, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(myers_cuda, name, counted)
    alpha = 0.1
    m, k = WORD_LEVEL[alpha] if path == "word" else POSITION_LEVEL[alpha]
    pats = [np.random.default_rng(1).choice(BASES, m)]
    Searcher("iupac", rc=True, alpha=alpha, device="cpu").search_many(
        pats, _reads(1, pats, 3, 200, 300), k)
    used, unused = (("scan_q_meta", "scan_q") if path == "word"
                    else ("scan_q", "scan_q_meta"))
    assert calls[used] >= 2 and calls[unused] == 0
