"""The port owns its host modules: no file of ``sassy_tpu_torch`` (nor
``chip_smoke.py``) imports the JAX package, and each of the port's copies
behaves as the original does: the profiles' tables, the overhang math,
the pattern plane masks, the DP matrix, the oracle's end costs and
candidates, the end-position scans, CIGARs, the N-fraction filters, the
traceback and the alignment iterator.

The port's ``Match`` and the reference's are different classes, so the
tests compare Match lists as (``sort_key()``, CIGAR string) tuples; the
last tests show that such a comparison sees every field.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest

import sassy_tpu
import sassy_tpu_torch
from sassy_tpu import Searcher as RefSearcher
from sassy_tpu import alignment_iterator as ref_ai
from sassy_tpu import cigar as ref_cigar
from sassy_tpu import matchrec as ref_matchrec
from sassy_tpu import nfilter as ref_nfilter
from sassy_tpu import oracle as ref_oracle
from sassy_tpu import profiles as ref_profiles
from sassy_tpu import semantics as ref_semantics
from sassy_tpu import traceback as ref_traceback
from sassy_tpu.ops import bitpack as ref_bitpack
from sassy_tpu.search import NumpyEngine
from sassy_tpu_torch import (
    Searcher,
    cigar,
    matchrec,
    nfilter,
    oracle,
    profiles,
    semantics,
    traceback,
)
from sassy_tpu_torch import alignment_iterator as ai
from sassy_tpu_torch.ops import bitpack

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    str(p.relative_to(REPO))
    for p in (REPO / "sassy_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]
GOLDEN = Path(__file__).parent / "golden"
BASES = np.frombuffer(b"ACGT", np.uint8)

PROFILE_PAIRS = {
    "dna": (profiles.Dna(), ref_profiles.Dna()),
    "iupac": (profiles.Iupac(), ref_profiles.Iupac()),
    "ascii": (profiles.Ascii(), ref_profiles.Ascii()),
    "ascii-insensitive": (profiles.Ascii(case_sensitive=False),
                          ref_profiles.Ascii(case_sensitive=False)),
}


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_nothing_of_the_jax_package(path):
    """Every import of the file, at any depth (inside functions too)."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = [m for m in _imported_modules(tree)
           if m in ("sassy_tpu", "jax") or m.startswith(("sassy_tpu.", "jax."))]
    assert not bad, f"{path} imports {bad}"


def test_port_files_are_all_found():
    assert len(PORT_FILES) > 15 and "sassy_tpu_torch/search.py" in PORT_FILES
    for sub in ("evals/bench_suite.py", "examples/modes.py", "refcost.py",
                "capi/__init__.py", "parallel/sharded.py",
                "parallel/multihost.py", "graft_entry.py", "tools/soak.py",
                "tools/bench.py", "tools/bench_oneshot.py",
                "tools/bench_traceback.py", "tools/bench_io_overlap.py",
                "tools/profile_readset.py",
                "tools/bench_sharded.py"):
        assert f"sassy_tpu_torch/{sub}" in PORT_FILES


def test_c_abi_source_imports_the_port():
    """The embedded interpreter of the port's C ABI imports the port, never
    the JAX package."""
    src = (REPO / "sassy_tpu_torch" / "capi" / "sassy_tpu_torch_c.cc"
           ).read_text()
    assert re.findall(r'PyImport_\w*\(\s*"([^"]*)"', src) == [
        "sassy_tpu_torch"]
    assert "PyImport_Import(" not in src and "jax" not in src


@pytest.mark.parametrize("name", list(PROFILE_PAIRS))
def test_profile_tables_equal_reference(name):
    """The encode table over all 256 bytes, the complement table where
    the profile has one, and every packing and semantics attribute."""
    port, ref = PROFILE_PAIRS[name]
    every = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(port.encode(every), ref.encode(every))
    if name in ("dna", "iupac"):
        assert port.complement(every) == ref.complement(every)
        assert (port.reverse_complement(b"ACGTRYN")
                == ref.reverse_complement(b"ACGTRYN"))
    for attr in ("name", "planes", "eq_mode", "supports_overhang",
                 "pack_mode", "pack_shift", "pack_mask", "pack_plane_masks",
                 "pack_fold_case", "pad_code", "overhang_pad_code"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    codes = port.encode(every)
    np.testing.assert_array_equal(port.match_mask(codes, codes),
                                  ref.match_mask(codes, codes))
    assert port.count_n(b"ANnNC") == ref.count_n(b"ANnNC")
    seqs = (b"ACGT", b"acgtn", b"ACGRYX", b"hello")
    assert [port.valid_seq(s) for s in seqs] == [ref.valid_seq(s) for s in seqs]


@pytest.mark.parametrize("name", ["dna", "iupac", "ascii", "ascii-insensitive",
                                  "ascii_insensitive"])
def test_get_profile_equals_reference(name):
    port, ref = profiles.get_profile(name), ref_profiles.get_profile(name)
    assert type(port).__name__ == type(ref).__name__
    assert getattr(port, "case_sensitive", None) == getattr(
        ref, "case_sensitive", None)


@pytest.mark.parametrize("alpha", [None, 0.0, 0.1, 0.25, 0.3, 0.5, 0.7, 1.0])
def test_semantics_equal_reference(alpha):
    """The overhang math over a grid of (m, k, max_overhang)."""
    for m in (1, 4, 23, 24, 100, 120, 127):
        for k in (0, 1, 3, 10, 63):
            for mo in (None, 0, 3, 50, 200):
                assert (semantics.overhang_steps(m, k, alpha, mo)
                        == ref_semantics.overhang_steps(m, k, alpha, mo))
            np.testing.assert_array_equal(
                semantics.init_h_deltas(m, alpha, mo),
                ref_semantics.init_h_deltas(m, alpha, mo))
            np.testing.assert_array_equal(
                semantics.left_boundary_costs(m, alpha, mo),
                ref_semantics.left_boundary_costs(m, alpha, mo))
    over = np.arange(-3, 400)
    assert ([semantics.overshoot_cost(alpha, int(o)) for o in over]
            == [ref_semantics.overshoot_cost(alpha, int(o)) for o in over])
    np.testing.assert_array_equal(
        semantics.overshoot_costs_vec(alpha, over),
        ref_semantics.overshoot_costs_vec(alpha, over))


@pytest.mark.parametrize("name", ["dna", "iupac", "ascii"])
def test_pattern_plane_masks_equal_reference(name):
    port, ref = PROFILE_PAIRS[name]
    pat = b"ACGTRYNacgt" if name != "ascii" else b"Hello, World"
    codes = port.encode(pat)
    np.testing.assert_array_equal(
        bitpack.pattern_plane_masks_np(codes, port.planes, port.eq_mode),
        ref_bitpack.pattern_plane_masks_np(codes, ref.planes, ref.eq_mode))
    assert bitpack.WORD_BITS == ref_bitpack.WORD_BITS


@pytest.mark.parametrize("alpha,mo", [(None, None), (0.5, None), (0.3, 2)])
def test_dp_matrix_equals_reference(alpha, mo):
    rng = np.random.default_rng(3)
    port, ref = PROFILE_PAIRS["iupac"]
    for m, n in ((5, 0), (12, 40), (30, 200)):
        p = port.encode(rng.choice(BASES, m))
        t = port.encode(rng.choice(np.frombuffer(b"ACGTN", np.uint8), n))
        np.testing.assert_array_equal(
            oracle.dp_matrix(port, p, t, alpha, mo),
            ref_oracle.dp_matrix(ref, p, t, alpha, mo))


ALPHAS = [None, 0.0, 0.5, 1.0]


def _oracle_inputs(seed: int):
    """Seeded (pattern codes, text) pairs of the iupac profile: IUPAC
    patterns, texts with N runs and planted copies, lengths from 1 up."""
    port, _ = PROFILE_PAIRS["iupac"]
    rng = np.random.default_rng(seed)
    iupac = np.frombuffer(b"ACGTNRYSWKM", np.uint8)
    out = []
    for m, n in ((1, 0), (4, 9), (7, 60), (12, 200), (23, 500)):
        pat = rng.choice(iupac if rng.random() < 0.4 else BASES, m)
        text = rng.choice(np.frombuffer(b"ACGTN", np.uint8), n)
        for _ in range(int(rng.integers(0, 3))):
            if n >= m:
                p = int(rng.integers(0, n - m + 1))
                text[p : p + m] = pat
        out.append((port.encode(pat), text))
    return out


@pytest.mark.parametrize("alpha", ALPHAS)
def test_end_costs_equals_reference(alpha):
    port, ref = PROFILE_PAIRS["iupac"]
    for mo in (None, 3):
        for p, t in _oracle_inputs(5):
            np.testing.assert_array_equal(
                oracle.end_costs(port, p, port.encode(t), alpha, mo),
                ref_oracle.end_costs(ref, p, ref.encode(t), alpha, mo))


@pytest.mark.parametrize("all_minima", [False, True])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_find_candidates_equal_reference(alpha, all_minima):
    """Both end-position scans over the oracle's total costs (overshoot
    included) of seeded inputs, and over random cost rows with plateaus."""
    port, _ = PROFILE_PAIRS["iupac"]
    rng = np.random.default_rng(6)
    rows = [rng.integers(0, 4, size=int(rng.integers(1, 40)))
            for _ in range(50)]
    for p, t in _oracle_inputs(7):
        n = len(t)
        steps = semantics.overhang_steps(len(p), 3, alpha, None)
        padded = np.concatenate([port.encode(t), np.full(
            steps, port.overhang_pad_code, np.uint8)])
        rows.append(oracle.end_costs(port, p, padded, alpha, None)
                    + semantics.overshoot_costs_vec(
                        alpha, np.arange(n + steps + 1) - n))
    for c in rows:
        for k in (0, 1, 3):
            want = ref_semantics.find_candidates(c, k, all_minima)
            assert semantics.find_candidates(c, k, all_minima) == want
            assert semantics.find_candidates_scalar(c, k, all_minima) == want
            assert (ref_semantics.find_candidates_scalar(c, k, all_minima)
                    == want)


@pytest.mark.parametrize("all_minima", [False, True])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_oracle_candidates_equal_numpy_engine(alpha, all_minima):
    port, ref = PROFILE_PAIRS["iupac"]
    ne = NumpyEngine()
    for mo in (None, 2):
        for p, t in _oracle_inputs(8):
            for k in (0, 2, 4):
                got = oracle.candidates(port, p, t, k, alpha, mo, all_minima)
                want = ne.candidates(ref, p, t, k, alpha, mo, all_minima)
                assert got == want
                assert all(type(x) is int for pair in got for x in pair)


def test_cigar_equals_reference():
    rng = np.random.default_rng(4)
    for _ in range(50):
        ops = "".join(rng.choice(list("=XID"), int(rng.integers(0, 30))))
        a, b = cigar.Cigar(), ref_cigar.Cigar()
        for op in ops:
            a.push(op)
            b.push(op)
        a.push_n("=", 3)
        b.push_n("=", 3)
        s = b.to_string()
        assert a.to_string() == s
        assert a.reversed().to_string() == b.reversed().to_string()
        assert cigar.Cigar.from_string(s).to_string() == s
        assert a.expand() == b.expand()
        assert bool(a) == bool(b)


def test_nfilter_equals_reference():
    rng = np.random.default_rng(5)
    text = rng.choice(np.frombuffer(b"ACGTNn", np.uint8), 500,
                      p=[.2, .2, .2, .2, .1, .1])
    for frac in (0.0, 0.05, 0.2, 1.0):
        for end in range(0, 520, 7):
            assert (nfilter.satisfy_n_endpoint_filter(end, text, 20, 3, frac)
                    == ref_nfilter.satisfy_n_endpoint_filter(end, text, 20, 3,
                                                            frac))
        for s in range(0, 480, 11):
            assert (nfilter.check_n_fraction(text, s, s + 20, frac)
                    == ref_nfilter.check_n_fraction(text, s, s + 20, frac))


def _fasta(path):
    recs, cur = [], []
    for line in path.read_text().splitlines():
        if line.startswith(">"):
            if cur:
                recs.append("".join(cur).encode())
            cur = []
        elif line.strip():
            cur.append(line.strip())
    if cur:
        recs.append("".join(cur).encode())
    return recs


PATTERNS = [p.encode() for p in (GOLDEN / "patterns2.txt").read_text().split()]
RECORDS = _fasta(GOLDEN / "corpus2.fa")


def _key(m):
    return m.sort_key(), m.cigar.to_string()


@pytest.mark.parametrize("k,alpha,mo", [(2, None, None), (3, None, None),
                                        (2, 0.5, None), (4, 0.3, 3)])
def test_trace_candidate_equals_reference_on_golden(k, alpha, mo):
    """Both traceback entry points, on the golden corpus's candidates (the
    numpy oracle's end positions), Match for Match with CIGAR."""
    port, ref = PROFILE_PAIRS["iupac"]
    eng = sassy_tpu.search.NumpyEngine()
    checked = 0
    for pat in PATTERNS[:8]:
        p = np.frombuffer(pat, np.uint8)
        codes = port.encode(p)
        for rec in RECORDS[:8]:
            t = np.frombuffer(rec, np.uint8)
            ends = [e for e, _ in eng.candidates(ref, codes, t, k, alpha, mo,
                                                 True)]
            want = ref_traceback.trace_candidates_batch(
                ref, p, codes, t, ends, len(p) + k, alpha, mo)
            got = traceback.trace_candidates_batch(
                port, p, codes, t, ends, len(p) + k, alpha, mo)
            assert [_key(m) for m in got] == [_key(m) for m in want]
            for e in ends[:5]:
                one = traceback.trace_candidate(port, p, codes, t, e,
                                                len(p) + k, alpha, mo)
                assert _key(one) == _key(ref_traceback.trace_candidate(
                    ref, p, codes, t, e, len(p) + k, alpha, mo))
            checked += len(ends)
    assert checked > 10


def test_search_all_alignments_equals_reference():
    port = Searcher("iupac", rc=True, device="cpu")
    ref = RefSearcher("iupac", rc=True, engine="numpy")
    for pat, text in ((b"ACGTTG", b"GGACGATGCCACGTTGAA"),
                      (b"ATCGGA", b"GGACCCATCACCCATCG")):
        got = port.search_all_alignments(pat, text, 2)
        want = ref.search_all_alignments(pat, text, 2)
        assert [[_key(m) for m in g] for g in got] == \
            [[_key(m) for m in g] for g in want]
        assert any(got)
    assert ai.net_insertions_since_last_match(cigar.Cigar.from_string(
        "3=2I1=1I")) == ref_ai.net_insertions_since_last_match(
        ref_cigar.Cigar.from_string("3=2I1=1I"))


def test_search_all_alignments_with_overhang_raises_as_reference():
    for s in (Searcher("iupac", alpha=0.5, device="cpu"),
              RefSearcher("iupac", alpha=0.5, engine="numpy")):
        with pytest.raises(AssertionError, match="overhang"):
            s.search_all_alignments(b"ACGTTG", b"GGACGATGCCACGTTGAA", 2)


def _match(mod, cig, **kw):
    fields = dict(pattern_idx=1, text_idx=2, text_start=10, text_end=20,
                  pattern_start=0, pattern_end=10, cost=1,
                  strand=mod.Strand.FWD, cigar=cig.Cigar.from_string("4=1X5="))
    fields.update(kw)
    return mod.Match(**fields)


def test_matches_of_the_two_packages_compare_by_key():
    """``same_as`` needs one Cigar class; the key tuples compare the two
    packages' Matches field for field."""
    port = _match(matchrec, cigar)
    ref = _match(ref_matchrec, ref_cigar)
    assert not port.same_as(ref)
    assert port.same_as(_match(matchrec, cigar))
    assert _key(port) == _key(ref)


@pytest.mark.parametrize("field,value", [
    ("pattern_idx", 0), ("text_idx", 3), ("text_start", 11),
    ("text_end", 21), ("pattern_start", 1), ("pattern_end", 9), ("cost", 2),
    ("strand", "RC"), ("cigar", "4=1X4=1I"),
])
def test_match_key_sees_every_field(field, value):
    ref = _match(ref_matchrec, ref_cigar)
    if field == "strand":
        value = matchrec.Strand.RC
    elif field == "cigar":
        value = cigar.Cigar.from_string(value)
    port = _match(matchrec, cigar, **{field: value})
    assert _key(port) != _key(ref)


def test_port_package_names_its_own_modules():
    assert sassy_tpu_torch.Match is matchrec.Match
    assert sassy_tpu_torch.Cigar is cigar.Cigar
    assert sassy_tpu_torch.profiles is profiles
