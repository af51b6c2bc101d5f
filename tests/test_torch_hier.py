"""The hierarchical suffix prefilter of both engines on the CPU:
``suffix_rows`` against the original, and searches with the prefilter
forced on (its gate, the work the suffix scan must save, set to 0) against the same searches
without it, the JAX package's XLA engine with its own prefilter on, and
the numpy oracle."""

import numpy as np
import pytest
import torch

from sassy_tpu import Searcher as RefSearcher
from sassy_tpu import profiles as ref_profiles
from sassy_tpu.ops.batch import _suffix_rows as ref_suffix_rows_batch
from sassy_tpu.ops.myers_xla import XlaEngine
from sassy_tpu.ops.myers_xla import suffix_rows as ref_suffix_rows
from sassy_tpu.search import NumpyEngine
from sassy_tpu_torch import Searcher, profiles
from sassy_tpu_torch.ops import batch, myers_cuda, plan
from sassy_tpu_torch.ops.myers_torch import TorchEngine

BASES = np.frombuffer(b"ACGT", np.uint8)


def _key(m):
    return m.pattern_idx, m.text_idx, m.sort_key(), m.cigar.to_string()


def _same(got, want):
    assert sorted(map(_key, got)) == sorted(map(_key, want)), (got, want)


@pytest.mark.parametrize("k", range(9))
def test_suffix_rows_equals_the_original(k):
    for m in range(1, 131):
        assert plan.suffix_rows(m, k) == ref_suffix_rows(m, k), (m, k)
        assert plan.suffix_rows(m, k) == ref_suffix_rows_batch(m, k), (m, k)


def test_suffix_rows_gate():
    """The cases of tests/test_batch.py's gate test."""
    assert plan.suffix_rows(72, 2) == 32
    assert plan.suffix_rows(24, 0) == 8
    assert plan.suffix_rows(80, 3) == 32  # selectivity needs 8 + 6k rows
    assert plan.suffix_rows(24, 3) == 0   # suffix would not be selective
    assert plan.suffix_rows(64, 5) == 0   # k too large for any suffix
    assert plan.suffix_rows(24, 8) == 0
    assert plan.suffix_rows(16, 3) == 0   # pattern not longer than suffix
    assert plan.suffix_rows(8, 0) == 0


def _mutate(pat, at):
    mut = pat.copy()
    mut[at] = BASES[(int(np.where(BASES == mut[at])[0][0]) + 1) % 4]
    return mut


def _planted(rng, n, m, offsets):
    """Random ACGT with the pattern (exact, then with one substitution,
    alternating) at ``offsets``."""
    text = rng.choice(BASES, size=n)
    pat = rng.choice(BASES, size=m)
    for i, off in enumerate(offsets):
        text[off : off + m] = pat if i % 2 == 0 else _mutate(pat, 7)
    return text, pat


class _Spy:
    """Counts the calls of a scan wrapper and records its pattern rows."""

    def __init__(self, monkeypatch, name):
        self.rows = []
        fn = getattr(myers_cuda, name)
        lead = 1 if name == "scan_q_meta" else 0

        def spy(*args):
            self.rows.append((args[4].shape[lead], args[0].shape[2]))
            return fn(*args)

        monkeypatch.setattr(myers_cuda, name, spy)


def test_single_gate(monkeypatch):
    """On where the suffix scan saves ``HIER_MIN_SAVED_PAIRS`` (row, word)
    pairs, for the iupac eq without overhang, and only where
    ``suffix_rows`` gives a suffix."""
    eng = TorchEngine("cpu")
    rng = np.random.default_rng(0)
    text, pat = _planted(rng, 6000, 80, [])
    iupac, ascii_ = profiles.Iupac(), profiles.Ascii()
    build = lambda prof, p, k, **kw: eng.build_inputs(  # noqa: E731
        prof, prof.encode(p), text, k, **kw)
    assert build(iupac, pat, 3).hier_s == 0  # a small text: under the gate
    inp = build(iupac, pat, 3)
    NW, _, T = inp.windows.shape
    saved = (80 - 32) * NW * T
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", saved)
    hier = lambda *a, **kw: build(*a, **kw).hier_s  # noqa: E731
    assert hier(iupac, pat, 3) == 32
    assert hier(profiles.Dna(), pat, 3) == 32
    assert hier(iupac, pat, 0) == 8  # 72 rows saved: over the gate too
    assert hier(iupac, pat[:24], 3) == 0
    assert hier(iupac, pat, 3, alpha=0.5) == 0
    assert hier(ascii_, pat, 3) == 0
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", saved + 1)
    assert hier(iupac, pat, 3) == 0


@pytest.mark.parametrize("method", ["search", "search_all"])
@pytest.mark.parametrize("m,k", [(80, 3), (24, 0), (33, 1), (64, 4)])
def test_single_prefilter_changes_no_result(m, k, method, monkeypatch):
    """Prefilter on against off and the oracle: copies at a text start, on
    a tile edge, next to each other and at the text end, both strands."""
    rng = np.random.default_rng(m + k)
    n = 9000
    text, pat = _planted(rng, n, m, [0, 512 - m // 2, 3000, 3000 + m + 3,
                                     n - m])
    rc = np.frombuffer(profiles.Iupac().reverse_complement(pat), np.uint8)
    text[6000 : 6000 + m] = rc
    port = Searcher("iupac", rc=True, device="cpu")
    off = getattr(port, method)(pat, text, k)
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", 0)
    spy = _Spy(monkeypatch, "scan_meta")
    on = getattr(port, method)(pat, text, k)
    S = plan.suffix_rows(m, k)
    # per strand: the suffix scan over every tile, the full scan over fewer
    (s_rows, t_all), (m_rows, t_flagged) = spy.rows[:2]
    assert (s_rows, m_rows) == (S, plan._bucket_rows(m))
    assert 0 < t_flagged < t_all and len(spy.rows) == 4
    assert len(on) >= 4
    _same(on, off)
    _same(on, getattr(RefSearcher("iupac", rc=True, engine="numpy"), method)(
        pat, text, k))


def test_single_prefilter_equals_xla_engine_with_its_prefilter(monkeypatch):
    """The reference's own prefilter test (tests/test_engine_xla.py): 3 Mbp,
    80 bp, k=4, the reference at its gate of 4096 tiles, the port forced
    on."""
    rng = np.random.default_rng(31)
    text = rng.choice(BASES, size=3_000_000)
    pat = rng.choice(BASES, size=80)
    for off, what in ((5, pat), (1_499_990, _mutate(pat, 7)),
                      (2_999_900, pat)):
        text[off : off + 80] = what
    ref_prof = ref_profiles.Iupac()
    hier = XlaEngine(target_tiles=8192)
    _, statics = hier.build_inputs(ref_prof, ref_prof.encode(pat), text, 4)
    assert statics["hier_s"] == 32
    want = hier.candidates(ref_prof, ref_prof.encode(pat), text, 4, None,
                           None, False)
    prof = profiles.Iupac()
    eng = TorchEngine("cpu")
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", 0)
    inp = eng.build_inputs(prof, prof.encode(pat), text, 4)
    assert inp.hier_s == 32 and inp.windows.shape[2] >= 4096
    got = eng.candidates(prof, prof.encode(pat), text, 4, None, None, False)
    assert got == sorted(want) and len(got) >= 3


def test_single_no_flagged_tile_launches_no_second_scan(monkeypatch):
    rng = np.random.default_rng(5)
    text = rng.choice(BASES, size=8000)
    pat = rng.choice(BASES, size=80)
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", 0)
    spy = _Spy(monkeypatch, "scan_meta")
    port = Searcher("iupac", rc=False, device="cpu")
    assert port.search(pat, text, 3) == []
    assert port.search_all(pat, text, 3) == []
    assert [r for r, _ in spy.rows] == [32, 32]


@pytest.mark.parametrize("m,k", [(16, 0), (32, 1)])
def test_plateau_across_flagged_tiles(m, k, monkeypatch):
    """Runs of A longer than an all-A pattern make plateaus of equal-cost
    ends; one run crosses the edge of two flagged tiles (512 chars each),
    others lie alone between unflagged tiles. ``search`` keeps one end per
    plateau, which takes the state chained over the gathered tiles."""
    rng = np.random.default_rng(m)
    text = np.frombuffer(b"CGT", np.uint8)[rng.integers(0, 3, 6000)].copy()
    for a, b in ((1000, 1060), (2500, 2500 + m + 5), (3560, 3600),
                 (5100, 5180)):
        text[a:b] = ord("A")
    if k:
        # cost 0, +1 at a C, flat at 1 across the tile edge at 1536, +1 at
        # the next C: the flat's last end follows a rise and is no match,
        # which only the state carried over the edge can tell
        text[1460:1560] = ord("A")
        text[[1520, 1548]] = ord("C")
    pat = np.full(m, ord("A"), np.uint8)
    port = Searcher("dna", rc=False, device="cpu")
    off = port.search(pat, text, k)
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", 0)
    flagged = []
    gather = TorchEngine.gather_tiles
    monkeypatch.setattr(
        TorchEngine, "gather_tiles",
        staticmethod(lambda inp, ids: flagged.append(ids.tolist())
                     or gather(inp, ids)))
    on = port.search(pat, text, k)
    (ids,) = flagged
    assert 1 in ids and 2 in ids and 8 not in ids, ids
    assert (3 in ids) == bool(k) and len(on) >= 4
    _same(on, off)
    _same(on, RefSearcher("dna", rc=False, engine="numpy").search(pat, text,
                                                                  k))


# ---------------------------------------------------------------- batched


def _reads(rng, m, n_pats=3):
    """Texts of several lengths (one shorter than the pattern) and patterns
    of one row bucket, copies planted across texts and strands."""
    texts = [rng.choice(BASES, size=n) for n in (3000, 700, 5000, 40, 2500)]
    pats = [rng.choice(BASES, size=m - q) for q in range(n_pats)]
    rc = lambda p: np.frombuffer(  # noqa: E731
        profiles.Iupac().reverse_complement(p), np.uint8)
    for q, (t, off) in enumerate(((0, 100), (2, 4000), (4, 2400))):
        p = pats[q % n_pats]
        texts[t][off : off + len(p)] = _mutate(p, 5)
    texts[2][1000 : 1000 + len(pats[0])] = pats[0]
    texts[0][2000 : 2000 + len(pats[1])] = rc(pats[1])
    texts[1][700 - len(pats[0]) :] = pats[0]
    return texts, pats


def test_batched_gate(monkeypatch):
    eng = batch.BatchEngine("cpu")
    iupac = profiles.Iupac()
    rng = np.random.default_rng(3)
    texts, pats = _reads(rng, 72)
    ts = batch.TextSet(texts, "cpu")
    rows = lambda ps, k, **kw: [g.hier_s for g in eng.groups(  # noqa: E731
        iupac, [iupac.encode(p) for p in ps], ts, k, **kw)]
    assert rows(pats, 2) == [32]
    assert rows(pats, 2, alpha=0.5) == [0]
    assert rows(pats + [pats[0][:20]], 0) == [8, 8]  # one row bucket each
    assert rows([pats[0], pats[0][:66]], 2) == [32]
    assert rows([pats[0], pats[0][:65]], 2)[0] in (0, 32)  # buckets 72, 72
    assert rows([pats[0][:63]], 2) == [0]  # the shortest pattern decides
    # a chunk under the gate scans every piece; at the gate, the suffix
    # first: patterns x rows saved x window words
    codes = [iupac.encode(p) for p in pats]
    spy = _Spy(monkeypatch, "scan_q_meta")
    eng.candidates_many(iupac, codes, ts, 2)
    assert [r for r, _ in spy.rows] == [72]
    (g,) = eng.groups(iupac, codes, ts, 2)
    pp = ts.piece_plan(g.halo, g.w_chars)
    saved = 3 * (72 - 32) * pp.NW * pp.T
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", saved + 1)
    eng.candidates_many(iupac, codes, ts, 2)
    assert [r for r, _ in spy.rows[1:]] == [72]
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", saved)
    eng.candidates_many(iupac, codes, ts, 2)
    assert [r for r, _ in spy.rows[2:]] == [32, 72]


@pytest.mark.parametrize("all_minima", [False, True])
@pytest.mark.parametrize("m,k", [(72, 2), (24, 0), (40, 1)])
def test_batched_prefilter_changes_no_result(m, k, all_minima, monkeypatch):
    rng = np.random.default_rng(m + k)
    texts, pats = _reads(rng, m)
    monkeypatch.setattr(plan, "H100_TARGET_TILES", 3 * 40)
    port = Searcher("iupac", rc=True, device="cpu")
    call = lambda s: s.search_many_with_fn(  # noqa: E731
        pats, texts, k, all_minima, None)
    off = call(port)
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", 0)
    spy = _Spy(monkeypatch, "scan_q_meta")
    on = call(port)
    S = plan.suffix_rows(m - 2, k)
    (s_rows, t_all), (m_rows, t_flagged) = spy.rows[:2]
    assert (s_rows, m_rows) == (S, plan._bucket_rows(m))
    assert 0 < t_flagged < t_all
    assert len(on) >= 3
    _same(on, off)
    _same(on, call(RefSearcher("iupac", rc=True, engine="numpy")))


def test_batched_no_flagged_piece_launches_no_second_scan(monkeypatch):
    rng = np.random.default_rng(9)
    texts = [rng.choice(BASES, size=n) for n in (2000, 900)]
    pats = [rng.choice(BASES, size=72) for _ in range(2)]
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", 0)
    spy = _Spy(monkeypatch, "scan_q_meta")
    assert Searcher("iupac", rc=False, device="cpu").search_many(
        pats, texts, 2) == []
    assert [r for r, _ in spy.rows] == [32]


@pytest.mark.parametrize("budget_pairs", [1, 3, 7, 1000])
def test_chunking_does_not_change_results_with_the_prefilter(budget_pairs,
                                                             monkeypatch):
    """``tests/test_torch_batch.py::test_chunking_does_not_change_results``
    with the prefilter on in every chunk: runs of A and of AAAAAAAC in
    CGT noise, 32 bp patterns of the same kinds at k=1, pieces of 512 chars
    in dispatch chunks of a few (pattern, piece) pairs. Plateaus of
    equal-cost ends cross piece and chunk edges; a chunk
    edge passes the state on only between flagged pieces, and the results
    are those of one chunk, of the search without the prefilter and of the
    oracle."""
    prof = profiles.Dna()
    rng = np.random.default_rng(budget_pairs)
    texts = []
    for n in (2500, 1800, 2100):
        t = np.frombuffer(b"CGT", np.uint8)[rng.integers(0, 3, n)].copy()
        for i in range(4):  # long low-complexity stretches between noise
            a = int(rng.integers(0, n - 400))
            t[a : a + 320] = (ord("A") if i % 2 else
                              np.frombuffer(b"AAAAAAAC" * 40, np.uint8))
        # cost 0, +1 at a C, flat at 1 across the piece edge at 512, +1 at
        # the next C: no match ends the flat, by the state carried over
        t[430:540] = ord("A")
        t[[500, 531]] = ord("C")
        texts.append(t)
    pats = [np.frombuffer(p, np.uint8) for p in (
        b"A" * 32, b"AAAAAAAC" * 4, b"A" * 20 + b"C" + b"A" * 11)]
    codes = [prof.encode(p) for p in pats]
    k = 1
    monkeypatch.setattr(batch, "W_MAX_WORDS", 16)  # pieces of 512 chars
    plain = batch.BatchEngine("cpu").candidates_many(prof, codes, texts, k)
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", 0)
    monkeypatch.setattr(batch, "DISPATCH_BYTES", 16 * 17 * budget_pairs)
    flagged = []
    pieces = batch.BatchEngine.flagged_pieces
    monkeypatch.setattr(
        batch.BatchEngine, "flagged_pieces",
        staticmethod(lambda *a: flagged.append(pieces(*a)) or flagged[-1]))
    chunked = batch.BatchEngine("cpu").candidates_many(prof, codes, texts, k)
    assert flagged and any(f.numel() for f in flagged)
    if budget_pairs == 1:
        assert any(f.numel() == 0 for f in flagged), "no chunk was skipped"
    assert chunked == plain
    assert sum(len(c) for row in plain for c in row) > 20
    oracle = NumpyEngine()
    ref_prof = ref_profiles.Dna()
    for q, c in enumerate(codes):
        for t, text in enumerate(texts):
            want = oracle.candidates(ref_prof, c, text, k, None, None, False)
            assert list(plain[q][t]) == sorted(want), (q, t)


def test_piece_plan_take():
    ts = batch.TextSet([b"ACGT" * 300, b"TTGA" * 100], "cpu")
    pp = ts.piece_plan(20, 512)
    ids = torch.tensor([2, 0])
    sub = pp.take(ids)
    assert (sub.T, sub.NW, sub.w_chars, sub.steps) == (2, pp.NW, 512, 0)
    assert sub.start_char.tolist() == pp.start_char[ids].tolist()
    assert sub.text_idx.tolist() == pp.text_idx[ids].tolist()
