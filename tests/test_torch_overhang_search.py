"""Overhang on the port's single-pattern engine: ``Searcher(..., alpha=...,
device="cpu")`` (the plain versions of the q1meta and q1 kernels) against
the JAX package's XLA engine and numpy oracle, Match for Match with CIGAR,
on both strands: the reference's pinned overhang cases, random texts with
copies hanging off both ends on the word-level path (an overshoot of at
most three words) and the position-level path (a longer one), every alpha
of {0.0, 0.1, 0.25, 0.5, 1.0}, ``max_overhang``, and the float32
overshoot cost."""

import numpy as np
import pytest

from sassy_tpu import Searcher as RefSearcher
from sassy_tpu_torch import Searcher, profiles, semantics
from sassy_tpu_torch.ops import minima, plan
from test_torch_cuda import _same

BASES = np.frombuffer(b"ACGT", np.uint8)
ALPHAS = [0.0, 0.1, 0.25, 0.5, 1.0]
#: position-level cases: (m, k) per alpha with an overshoot span of more
#: than three words (n_prev >= 5)
POSITION_LEVEL = {0.0: (110, 5), 0.1: (110, 10), 0.25: (110, 25),
                  0.5: (110, 48), 1.0: (110, 96)}


def _n_prev(m, k, alpha, mo=None):
    return semantics.overhang_steps(m, k, alpha, mo) // 32 + (
        semantics.overhang_steps(m, k, alpha, mo) % 32 > 0) + 1


def _overhung(seed, n, pat, hang):
    """Random ACGT text with the pattern hanging ``hang`` chars off its
    start and off its end, on both strands, and one interior copy."""
    rng = np.random.default_rng(seed)
    text = rng.choice(BASES, n)
    m = len(pat)
    comp = np.zeros(256, np.uint8)
    comp[list(b"ACGT")] = list(b"TGCA")
    rc = comp[pat[::-1]]
    text[: m - hang] = pat[hang:]
    text[n - (m - hang) :] = pat[: m - hang]
    q = n // 4
    text[q : q + m - hang] = rc[hang:]  # the RC strand's end ...
    text[2 * q : 2 * q + m] = pat
    text[3 * q - (m - hang) : 3 * q] = rc[: m - hang]
    return text


# the overhang cases of tests/test_basic.py and
# tests/reference_pinned/test_search_pinned.py: (pattern, text, k, alpha,
# rc, max_n_frac)
PINNED = {
    "librs_overhang_example": (b"ACGT", b"GTXXXNNN", 1, 0.5, False, None),
    "n_filter_full_overhang": (b"AAAA", b"GGGGGG", 2, 0.5, False, 0.0),
    "overshoot_simple_prefix": (b"AAAAGGGG", b"GGGGTTTTTTTTTTTTTTTT", 2, 0.5,
                                False, None),
    "overshoot_simple_suffix": (b"GGGGAAAA", b"TTTTTTTTTTTTTTTTGGGG", 2, 0.5,
                                False, None),
    "overshoot_suffix_local_minima": (b"GGGGAAAA", b"TTTTTTTTTTTTTTTTGGGG", 4,
                                      0.5, False, None),
    "overshoot_prefix_and_suffix": (b"AAAAGGGG", b"GGGGGAAAAA", 2, 0.5, False,
                                    None),
    "case3_large_k": (
        b"GTCTTTCATTCTCTCATCATAATCTCTAATACGACACATTGTACATCTGCTTGCGAGCCGGTGTAGCGC"
        b"CGTCCTGTTATTTCAAGGCTATAATTACGAATTCAATTCCTCCTCTTCCAAAACACG",
        b"AGTGATATCTCAAGGGGCCCTATTGGAAGGAAAGCCGCGATGGGTTCAACGTCAAGTGGATCATTCGAT"
        b"ATTCATTAGCCCAACAGAAAC", 63, 0.4, False, None),
    "case4": (b"ATC", b"CGGGGGG", 3, 0.5, False, None),
    "match_exact_at_end": (b"ATAC", b"CCCCCCATAC", 0, 0.5, False, None),
    "fwd_rc_simple": (b"ATCATGCTAGC", b"GGGGGGGGGGATCATGCTAGCGGGGGGGGGGG", 0,
                      0.5, True, None),
    "alpha_zero_large_k": (
        b"CTTAAGCACTACCGGCTAAT",
        b"AGTCGTCCTTTGCGAGCTCGGACATCTCCAGGCGAACCTGCAAGTTTTAATGTTCCCACAGTCCCTCAT"
        b"ATGTTCTGAATTTCGTGATGTTTGTTTACCG", 100, 0.0, False, None),
}


@pytest.mark.parametrize("engine", ["numpy", "xla"])
@pytest.mark.parametrize("name", list(PINNED))
def test_pinned_overhang_cases_equal_reference(name, engine):
    pat, text, k, alpha, rc, nfrac = PINNED[name]
    port = Searcher("iupac", rc=rc, alpha=alpha, device="cpu")
    ref = RefSearcher("iupac", rc=rc, alpha=alpha, engine=engine)
    if nfrac is not None:
        port.with_max_n_frac(nfrac)
        ref.with_max_n_frac(nfrac)
    for method in ("search", "search_all"):
        got = getattr(port, method)(pat, text, k)
        _same(got, getattr(ref, method)(pat, text, k))
    assert got or name == "alpha_zero_large_k"


@pytest.mark.parametrize("engine", ["numpy", "xla"])
@pytest.mark.parametrize("path", ["word", "position"])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_overhang_search_equals_reference(alpha, path, engine, monkeypatch):
    """Copies hanging off both ends on both strands, search and
    search_all, on the word-level path (24 bp, k=3: n_prev <= 4) with
    several body tiles and the tail tile, or the position-level path."""
    m, k = (24, 3) if path == "word" else POSITION_LEVEL[alpha]
    assert (_n_prev(m, k, alpha) <= 4) == (path == "word")
    monkeypatch.setattr(plan, "H100_TARGET_TILES", 8)
    rng = np.random.default_rng(int(alpha * 100) + m)
    pat = rng.choice(BASES, m)
    n = 2500 if path == "word" else 700
    text = _overhung(m + k, n, pat, hang={0.0: 9, 1.0: 2}.get(alpha, 4))
    port = Searcher("iupac", rc=True, alpha=alpha, device="cpu")
    ref = RefSearcher("iupac", rc=True, alpha=alpha, engine=engine)
    methods = ("search", "search_all") if k < 40 else ("search",)
    for method in methods:
        got = getattr(port, method)(pat, text, k)
        _same(got, getattr(ref, method)(pat, text, k))
    assert any(mt.text_end == n or mt.text_start == 0 for mt in got)


@pytest.mark.parametrize("path,m,k,alpha,mo", [
    ("word", 24, 3, 0.5, 0),
    ("word", 24, 3, 0.5, 3),
    ("word", 24, 6, 0.25, 10),
    ("position", 110, 5, 0.0, 100),
    ("word", 110, 5, 0.0, 60),
])
def test_max_overhang_equals_oracle(path, m, k, alpha, mo, monkeypatch):
    assert (_n_prev(m, k, alpha, mo) <= 4) == (path == "word")
    monkeypatch.setattr(plan, "H100_TARGET_TILES", 8)
    pat = np.random.default_rng(m + mo).choice(BASES, m)
    text = _overhung(mo, 900, pat, hang=min(m // 3, 8))
    port = Searcher("iupac", rc=True, alpha=alpha, device="cpu")
    ref = RefSearcher("iupac", rc=True, alpha=alpha, engine="numpy")
    for method in ("search", "search_all"):
        got = getattr(port.with_max_overhang(mo), method)(pat, text, k)
        _same(got, getattr(ref.with_max_overhang(mo), method)(pat, text, k))
    assert got


@pytest.mark.parametrize("k", [6, 7])
def test_overshoot_cost_is_float32_end_to_end(k):
    """At alpha 0.7 a 10-char overshoot costs floor(f32(0.7) * 10) = 7 (in
    float64 it would be 6): with k = 6 the exact overhang match at the
    text end is no match, with k = 7 it is."""
    rng = np.random.default_rng(1)
    pat = rng.choice(BASES, 20)
    text = np.concatenate([rng.choice(BASES, 300), pat[:10]])
    port = Searcher("iupac", alpha=0.7, device="cpu")
    got = port.search_all(pat, text, k)
    _same(got, RefSearcher("iupac", alpha=0.7, engine="numpy").search_all(
        pat, text, k))
    at_end = [mt for mt in got if mt.text_end == 310 and mt.pattern_end == 10]
    assert [mt.cost for mt in at_end] == ([7] if k == 7 else [])


def test_chunked_position_level_selection_changes_nothing(monkeypatch):
    monkeypatch.setattr(plan, "H100_TARGET_TILES", 8)
    pat = np.random.default_rng(3).choice(BASES, 110)
    text = _overhung(3, 1500, pat, hang=9)
    port = Searcher("iupac", rc=True, alpha=0.1, device="cpu")
    whole = port.search(pat, text, 10)
    monkeypatch.setattr(minima, "POSITIONS_PER_CHUNK", 1)  # one tile each
    _same(port.search(pat, text, 10), whole)
    _same(whole, RefSearcher("iupac", rc=True, alpha=0.1,
                             engine="numpy").search(pat, text, 10))


@pytest.mark.parametrize("option", ["without_trace", "only_best_match",
                                    "filter_fn"])
def test_overhang_options_equal_oracle(option):
    pat = np.random.default_rng(4).choice(BASES, 16)
    text = _overhung(4, 400, pat, hang=3)
    port = Searcher("iupac", rc=True, alpha=0.5, device="cpu")
    ref = RefSearcher("iupac", rc=True, alpha=0.5, engine="numpy")
    if option == "filter_fn":
        keep = lambda q, t, strand: len(t) % 2 == 0  # noqa: E731
        got = port.search_with_fn(pat, text, 3, True, keep)
        want = ref.search_with_fn(pat, text, 3, True, keep)
    else:
        getattr(port, option)()
        getattr(ref, option)()
        got, want = port.search(pat, text, 3), ref.search(pat, text, 3)
    if option == "without_trace":
        key = lambda m: m.sort_key()  # noqa: E731
        assert [key(m) for m in got] == [key(m) for m in want]
    else:
        _same(got, want)
    assert got


@pytest.mark.parametrize("build", [
    lambda: Searcher("dna", alpha=0.5, device="cpu"),
    lambda: Searcher("dna", device="cpu").with_overhang(0.5),
    lambda: Searcher("iupac", alpha=1.5, device="cpu"),
    lambda: Searcher.new_rc_with_overhang(profiles.Dna(), 0.5, device="cpu"),
])
def test_overhang_checks_raise_as_reference(build):
    with pytest.raises(ValueError):
        build()


def test_overhang_builders():
    s = Searcher.new_fwd_with_overhang(profiles.Iupac(), 0.5, device="cpu")
    assert s.alpha == 0.5 and not s.rc
    r = Searcher("iupac", rc=True, device="cpu").with_overhang(0.25)
    assert r.alpha == 0.25
    got = r.with_max_overhang(2).search(b"ACGTTG", b"TTGCCCCCCCACG", 1)
    want = RefSearcher("iupac", rc=True, alpha=0.25, engine="numpy") \
        .with_max_overhang(2).search(b"ACGTTG", b"TTGCCCCCCCACG", 1)
    _same(got, want)


def test_overhang_past_the_tail_reserve_raises():
    """An overshoot longer than the planes' reserved tail words raises, as
    the reference engine does."""
    pat = np.random.default_rng(5).choice(BASES, 2100)
    with pytest.raises(ValueError, match="overhang"):
        Searcher("iupac", alpha=0.0, device="cpu").search(pat, pat[:50], 3)


# zero overhang steps with alpha set: no tail tile, so the body tiles keep
# the text's last position (the reference's XLA engine drops it, so these
# cases hold the port to the numpy oracle)
ZERO_STEPS = [
    (b"GA", b"TTTTTTTTTTG", 1, 0.5, 0),
    (b"", b"TTTTTTTTTTG", 1, 0.0, None),
    (b"", b"TTTTTTTTTTG", 1, 0.5, None),
]


@pytest.mark.parametrize("rc", [False, True])
@pytest.mark.parametrize("case", ZERO_STEPS)
@pytest.mark.parametrize("entry", ["search", "search_many"])
def test_zero_overhang_steps_keep_the_text_end_match(entry, case, rc):
    pat, text, k, alpha, mo = case
    port = Searcher("iupac", rc=rc, alpha=alpha, device="cpu")
    ref = RefSearcher("iupac", rc=rc, alpha=alpha, engine="numpy")
    if mo is not None:
        port.with_max_overhang(mo)
        ref.with_max_overhang(mo)
    want = ref.search(pat, text, k)
    if entry == "search":
        got = port.search(pat, text, k)
    else:
        got = port.search_many([pat], [text], k)
    _same(got, want)
    assert any(m.text_end == len(text) for m in got)


@pytest.mark.parametrize("seed", range(4))
def test_zero_overhang_steps_sweep_equals_oracle(seed, monkeypatch):
    """Random texts that end in the pattern less its last ``d`` chars (or
    in an exact copy, d = 0), at ``with_max_overhang(0)``, over several
    body tiles. A match that ends with deletions keeps its cost one
    position past the text end, so only the text end's own bound makes it
    a minimum there."""
    monkeypatch.setattr(plan, "H100_TARGET_TILES", 4)
    rng = np.random.default_rng(100 + seed)
    alpha = [0.0, 0.25, 0.5, 1.0][seed]
    port = Searcher("iupac", rc=True, alpha=alpha,
                    device="cpu").with_max_overhang(0)
    ref = RefSearcher("iupac", rc=True, alpha=alpha,
                      engine="numpy").with_max_overhang(0)
    for _ in range(6):
        m = int(rng.integers(2, 30))
        d = int(rng.integers(0, min(m, 3)))
        k = d + int(rng.integers(0, 2))
        pat = rng.choice(BASES, m)
        text = np.concatenate([rng.choice(BASES, int(rng.integers(1, 600))),
                               pat[: m - d]])
        for method in ("search", "search_all"):
            got = getattr(port, method)(pat, text, k)
            _same(got, getattr(ref, method)(pat, text, k))
        assert any(mt.text_end == len(text) for mt in got)
        _same(port.search_many([pat], [text], k), ref.search(pat, text, k))
