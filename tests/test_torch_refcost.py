"""The port's refcost (``sassy_tpu_torch.refcost``): the same end costs
and edit distances as the JAX package's ``sassy_tpu.refcost`` over a
seeded sweep of every alphabet, with overhang; the port's CPU engine's
match costs equal to the C++ DP's (after
tests/test_refcost_differential.py); the build writes only into its build
directory, never next to the source; no compiler, no library."""

import shutil

import numpy as np
import pytest

from sassy_tpu import profiles as ref_profiles
from sassy_tpu import refcost as ref_refcost
from sassy_tpu_torch import Searcher, gxx, profiles, refcost


@pytest.fixture(scope="module", autouse=True)
def _compiler():
    if refcost.load() is None:
        pytest.skip("no C++ toolchain")


IUPAC_BASES = b"ACGTNRYSWKMBDHVU"
PROFILES = {
    "iupac": (profiles.Iupac(), ref_profiles.Iupac(), IUPAC_BASES, b"ACGTN"),
    "dna": (profiles.Dna(), ref_profiles.Dna(), b"ACGTacgt", b"ACGTNacgt"),
    "ascii": (profiles.Ascii(), ref_profiles.Ascii(), b"abAB xyXY",
              b"abAB xyXY"),
    "ascii-insensitive": (profiles.Ascii(case_sensitive=False),
                          ref_profiles.Ascii(case_sensitive=False),
                          b"abAB xyXY", b"abAB xyXY"),
}


@pytest.mark.parametrize("name", list(PROFILES))
def test_end_costs_and_edit_distance_equal_reference(name):
    port_p, ref_p, pat_bases, text_bases = PROFILES[name]
    rng = np.random.default_rng(sum(name.encode()))
    pb = np.frombuffer(pat_bases, np.uint8)
    tb = np.frombuffer(text_bases, np.uint8)
    for _ in range(60):
        pat = bytes(rng.choice(pb, int(rng.integers(1, 30))))
        text = bytes(rng.choice(tb, int(rng.integers(0, 120))))
        alpha, mo = None, None
        if name == "iupac":
            alpha = [None, 0.0, 0.25, 0.5, 1.0][int(rng.integers(5))]
            if alpha is not None and rng.random() < 0.4:
                mo = int(rng.integers(0, len(pat) + 1))
        got = refcost.end_costs(port_p, pat, text, alpha, mo)
        want = ref_refcost.end_costs(ref_p, pat, text, alpha, mo)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=repr((pat, text)))
        assert refcost.edit_distance(port_p, pat, text) == \
            ref_refcost.edit_distance(ref_p, pat, text)
    # numpy arrays as well as bytes
    arr = np.frombuffer(b"ACGTTGCA", np.uint8)
    np.testing.assert_array_equal(
        refcost.end_costs(port_p, arr[:3], arr),
        ref_refcost.end_costs(ref_p, arr[:3], arr))


def test_edit_distance_basics():
    prof = profiles.Dna()
    assert refcost.edit_distance(prof, b"ACGT", b"ACGT") == 0
    assert refcost.edit_distance(prof, b"ACGT", b"AGT") == 1
    assert refcost.edit_distance(prof, b"ACGT", b"TTTT") == 3
    assert refcost.edit_distance(profiles.Iupac(), b"ACGT", b"NNNN") == 0


@pytest.mark.parametrize("name", ["iupac", "dna"])
def test_cpu_engine_match_costs_equal_cpp(name):
    """Every reported match cost equals the C++ end cost at that end
    position (a planted exact occurrence, any k)."""
    prof = PROFILES[name][0]
    rng = np.random.default_rng(88 + len(name))
    acgt = np.frombuffer(b"ACGT", np.uint8)
    s = Searcher(prof, rc=False, device="cpu")
    for _ in range(20):
        m = int(rng.integers(8, 30))
        pattern = bytes(rng.choice(acgt, m))
        text = bytearray(rng.choice(acgt, int(rng.integers(m, 400))))
        pos = int(rng.integers(0, len(text) - m + 1))
        text[pos : pos + m] = pattern
        text = bytes(text)
        k = int(rng.integers(0, 4))
        cpp = refcost.end_costs(prof, pattern, text)
        got = s.search_all(pattern, text, k)
        for match in got:
            assert cpp[match.text_end] == match.cost, (pattern, text, k,
                                                       match)
        assert any(mm.cost == 0 and mm.text_end == pos + m for mm in got)


def test_build_writes_only_into_the_build_dir(tmp_path, monkeypatch):
    """Built from a copy of native/: the copy holds its one source,
    byte-identical, and the library lands in the build directory."""
    orig = refcost.SOURCE
    src = tmp_path / "native" / "refcost.cc"
    src.parent.mkdir()
    shutil.copyfile(orig, src)
    monkeypatch.setattr(refcost, "SOURCE", src)
    monkeypatch.setattr(gxx, "BUILD_DIR", tmp_path / "build")
    lib = refcost.build()
    assert lib.parent == tmp_path / "build"
    assert lib.name.startswith("librefcost_") and lib.suffix == ".so"
    assert [p.name for p in (tmp_path / "build").iterdir()] == [lib.name]
    assert [p.name for p in src.parent.iterdir()] == ["refcost.cc"]
    assert src.read_bytes() == orig.read_bytes()
    assert refcost.load() is not None
    assert refcost.end_costs(profiles.Dna(), b"AC", b"TAC")[-1] == 0


def test_no_compiler_no_library(tmp_path, monkeypatch):
    monkeypatch.setattr(gxx, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(gxx.shutil, "which", lambda name: None)
    assert refcost.load() is None
    assert refcost.end_costs(profiles.Dna(), b"AC", b"TAC") is None
    assert refcost.edit_distance(profiles.Dna(), b"AC", b"TAC") is None
