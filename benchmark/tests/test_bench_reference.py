"""The reference agrees with a brute-force DP, one cell at a time."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import dp, search

BASES = np.frombuffer(b"ACGT", np.uint8)


def _dp(pc, tc):
    """The whole DP, one cell at a time."""
    m, n = len(pc), len(tc)
    D = np.zeros((m + 1, n + 1), np.int64)
    D[:, 0] = np.arange(m + 1)
    for j in range(1, m + 1):
        for i in range(1, n + 1):
            D[j, i] = min(D[j - 1, i - 1] + (0 if pc[j - 1] & tc[i - 1] else 1),
                          D[j - 1, i] + 1, D[j, i - 1] + 1)
    return D


def brute(patterns, texts, k):
    """Every match of every pattern in every text on both strands."""
    out = set()
    for q, p in enumerate(patterns):
        for t, x in enumerate(texts):
            n = len(x)
            for s in (0, 1):
                pc = dp.encode(p if s == 0 else dp.complement(p))
                tc = dp.encode(x if s == 0 else x[::-1])
                m = len(pc)
                for e in dp.report_ends_scalar(_dp(pc, tc)[m], k):
                    w = min(e, m + k)
                    i, cost, cigar = dp.walk(pc, tc[e - w:e],
                                             _dp(pc, tc[e - w:e]))
                    start, end = e - w + i, e
                    if s:
                        start, end = n - end, n - start
                    out.add((q, t, s, start, end, 0, m, cost, cigar))
    return out


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    patterns = [rng.choice(BASES, 8) for _ in range(3)]
    patterns.append(np.frombuffer(b"ACGTNGG", np.uint8))
    texts = [rng.choice(BASES, n) for n in (5, 40, 300, 700)]
    texts[2][100:108] = patterns[0]
    texts[3][400:407] = np.frombuffer(b"ACGTAGG", np.uint8)
    texts[3][600:608] = dp.complement(patterns[1])[::-1]
    return patterns, texts, 2, brute(patterns, texts, 2)


def test_whole_texts_equal_brute_force(data):
    patterns, texts, k, want = data
    areas = [search.Area(t, 0, len(x)) for t, x in enumerate(texts)]
    got, checked = search.search_areas(patterns, texts, k, areas, "cpu",
                                       max_cells=4000)
    assert got == want
    assert len(checked) == 2 * len(patterns) * len(texts)


@pytest.mark.parametrize("area", [
    search.Area(3, 200, 650), search.Area(3, 500, 700, (3,), (1,)),
    search.Area(2, 90, 120), search.Area(3, 690, 700, (0, 1), (0,))])
def test_areas_equal_brute_force_in_their_ranges(data, area):
    """An area's matches are the brute force's in the ranges it checked,
    which cover the area where its costs turn."""
    patterns, texts, k, want = data
    got, checked = search.search_areas(patterns, texts, k, [area], "cpu")
    sel = set()
    for t, s, q, lo, hi in checked.tolist():
        n = len(texts[t])
        sel |= {w for w in want if (w[0], w[1], w[2]) == (q, t, s)
                and lo <= (w[4] if s == 0 else n - w[3]) <= hi}
    assert got == sel
    assert len(checked)


def test_report_ends_equal_the_scalar_rule():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 4, size=(200, 30))
    c[:, :3] = 3
    mask, falling = dp.report_ends(torch.from_numpy(c), 1)
    for row, got, f in zip(c, mask.numpy(), falling.numpy()):
        want = dp.report_ends_scalar(row, 1)
        if f[-1] and row[-1] <= 1:
            want = want[:-1]  # the last position's rule is the caller's
        assert np.flatnonzero(got).tolist() == want


def test_walk_takes_a_match_first():
    p, t = dp.encode(np.frombuffer(b"ACGT", np.uint8)), dp.encode(
        np.frombuffer(b"ACCGT", np.uint8))
    D = _dp(p, t)
    assert dp.walk(p, t, D) == (1, 1, "1X3=")
    assert dp.cigar_string(list("==XX=I")) == "2=2X1=1I"


def test_iupac_tables():
    assert dp.encode(np.frombuffer(b"N", np.uint8))[0] == 15
    assert bytes(dp.complement(np.frombuffer(b"ACGTNRY", np.uint8))) \
        == b"TGCANYR"
