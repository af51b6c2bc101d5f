"""Overhang on the port's batched engine: the piece planner and the piece
windows with overshoot steps against the JAX package's, ``BatchEngine``
against the reference's XLA batched engine, and the port's
``Searcher(..., alpha=..., device="cpu")`` batched entry points against
the reference's ``engine="xla"`` and ``engine="numpy"``, Match for Match
with CIGAR, both strands: the word-level path (q2meta's plain version)
and the position-level path (q2's), unequal pattern lengths, and dispatch
chunks that change no result."""

import dataclasses

import numpy as np
import pytest
import torch

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
        prof, [prof.encode(p) for p in pats], batch.TextSet(texts, "cpu"), k,
        alpha)
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
    ts = batch.TextSet(texts, "cpu")
    (g,) = batch.BatchEngine("cpu").groups(
        profiles.Iupac(), [profiles.Iupac().encode(p) for p in pats], ts, k,
        alpha)
    pp = ts.piece_plan(g.halo, g.w_chars, g.steps)
    chunks = list(batch.BatchEngine.chunks(g, pp))
    ranges = [r for q0, q1, t0, t1 in chunks
              for r in batch.BatchEngine.select_ranges(g, pp, q1 - q0, t0, t1,
                                                       "cpu")]
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


def _position_group(monkeypatch, alpha=0.1, budget=None):
    """A position-level group over a few texts on the CPU, its piece plan
    and its first dispatch chunk, with ``POSITIONS_PER_CHUNK`` at
    ``budget`` expanded positions."""
    m, k = POSITION_LEVEL[alpha]
    rng = np.random.default_rng(int(alpha * 100) + 3)
    # pattern 0 against a run of A after an exact copy: its cost rises to
    # a plateau <= k whose last position is no candidate, since the state
    # there is the rise's, carried across pieces; the runs start at
    # offsets spread over a piece's width
    run = np.frombuffer(b"A" * (m - 4) + b"CCCC", np.uint8).copy()
    pats = [run] + [rng.choice(BASES, m) for _ in range(2)]
    texts = [np.concatenate([rng.choice(BASES, r), run,
                             np.full(m - 20, ord("A"), np.uint8),
                             rng.choice(BASES, 300)])
             for r in range(100, 1400, 61)]
    texts += _reads(4, pats, 6, 300, 1500, hang=3)
    ts = batch.TextSet(texts, "cpu")
    prof = profiles.Iupac()
    (g,) = batch.BatchEngine("cpu").groups(
        prof, [prof.encode(p) for p in pats], ts, k, alpha)
    pp = ts.piece_plan(g.halo, g.w_chars, g.steps)
    if budget is not None:
        monkeypatch.setattr(minima, "POSITIONS_PER_CHUNK",
                            budget * g.Q * pp.NW * 32)
    assert not g.fast
    return prof, ts, g, pp, k, next(batch.BatchEngine.chunks(g, pp))


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "cpu"])
def test_select_ranges_one_range_a_chunk_on_cuda(device, monkeypatch):
    """The position level's selection runs over the whole dispatch chunk
    for scan outputs on a CUDA device (the kernel keeps no temporaries)
    and over sub-ranges of at most POSITIONS_PER_CHUNK expanded positions,
    in order, for CPU tensors; the word level always over the whole
    chunk. Only the device is asked, so no card is needed."""
    _, _, g, pp, _, (q0, q1, t0, t1) = _position_group(monkeypatch,
                                                       budget=3)
    assert t1 - t0 > 6
    ranges = list(batch.BatchEngine.select_ranges(g, pp, q1 - q0, t0, t1,
                                                  torch.device(device)))
    if device == "cpu":
        assert len(ranges) == -(-(t1 - t0) // 3)
        assert all(b - a <= 3 for a, b in ranges)
    else:
        assert ranges == [(t0, t1)]
    assert ranges[0][0] == t0 and ranges[-1][1] == t1
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    word = dataclasses.replace(g, n_prev=0)
    assert word.fast
    assert list(batch.BatchEngine.select_ranges(
        word, pp, q1 - q0, t0, t1, torch.device(device))) == [(t0, t1)]


SELECT_CASES = [(0.1, False, 0, False), (0.1, True, 3, False),
                (0.1, False, 3, False), (0.25, False, 3, True),
                (0.0, False, 0, True), (0.5, True, 0, True)]


@pytest.mark.parametrize("alpha,all_minima,carry,reverse", SELECT_CASES)
def test_select_whole_chunk_equals_sub_ranges(alpha, all_minima, carry,
                                              reverse, monkeypatch):
    """On the CPU, ``BatchEngine.select`` over a whole dispatch chunk (as
    the card runs it) equals the chain of its calls over the sub-ranges
    of ``select_ranges``, columns and carry out: overhang or not,
    all_minima, pieces that start a text inside the range, a carry in,
    and cost plateaus whose state crosses the pieces and the ranges."""
    prof, ts, g, pp, k, (q0, q1, t0, t1) = _position_group(
        monkeypatch, alpha, budget=2)
    # from the first text's second piece: the carry in is its state
    t0 += 1
    assert not pp.true_start[t0] and pp.true_start[t0 + 1 : t1].any()
    win = ts.descriptor(prof, pp, reverse, t0, t1)
    outs = batch.BatchEngine.scan(win, g, pp, q0, q1, t0, t1, k)
    carry_in = torch.full((q1 - q0, 1), carry, dtype=torch.int32)
    carry_in[::2] = 3 - carry
    whole, whole_carry = batch.BatchEngine.select(
        outs, g, pp, q0, t0, t1, k, all_minima, carry_in)
    parts, c = [], carry_in
    ranges = list(batch.BatchEngine.select_ranges(g, pp, q1 - q0, t0, t1,
                                                  "cpu"))
    assert len(ranges) > 2
    for s0, s1 in ranges:
        part = tuple(o[..., s0 - t0 : s1 - t0] for o in outs)
        cols, c = batch.BatchEngine.select(part, g, pp, q0, s0, s1, k,
                                           all_minima, c)
        parts.append(cols)
    chained = torch.cat(parts, 1)
    # the same candidates, each range's in (pattern, piece, position) order
    key = lambda x: np.lexsort(x.numpy()[::-1])  # noqa: E731
    assert whole.shape == chained.shape and whole.shape[1]
    assert torch.equal(whole[:, key(whole)], chained[:, key(chained)])
    assert torch.equal(whole_carry, c)
