"""The port's Searcher on the CPU (the kernels' plain versions) against
the JAX package's numpy oracle and XLA engine: Match lists with CIGAR,
both strands, with and without overhang; the port imports neither JAX nor
the JAX package; the CUDA path has no fallback."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sassy_tpu import CachedRev as RefCachedRev
from sassy_tpu import Searcher as RefSearcher
from sassy_tpu_torch import CachedRev, Searcher, profiles

GOLDEN = Path(__file__).parent / "golden"
REPO = Path(__file__).resolve().parent.parent


def _key(m):
    return m.sort_key(), m.cigar.to_string()


def _same(got, want):
    """Equal Match lists, field for field with the CIGAR string: the port's
    Match and the reference's are different classes, so ``same_as`` (whose
    Cigar equality needs one class) cannot compare them."""
    assert [_key(m) for m in got] == [_key(m) for m in want], (got, want)


# the non-overhang examples of tests/test_basic.py:
# (profile, rc, max_n_frac, only_best, without_trace, method, pattern, text, k)
BASIC = {
    "readme_iupac": ("iupac", False, 0.4, False, False, "search", b"ATCG",
                     b"AAAATTGAAA", 1),
    "librs_fwd_dna": ("dna", False, None, False, False, "search", b"ATCG",
                      b"CCCATCACCC", 1),
    "librs_rc_dna": ("dna", True, None, False, False, "search", b"ATCG",
                     b"CCCATCACCC", 1),
    "n_filter_off": ("iupac", False, None, False, False, "search_all",
                     b"ACGTACGTACGT",
                     b"NNNNNNNNNNNNNAAAAAAAAAAAAAAAAAANNNNNNNGTACGT", 1),
    "n_filter_on": ("iupac", False, 0.5, False, False, "search_all",
                    b"ACGTACGTACGT",
                    b"NNNNNNNNNNNNNAAAAAAAAAAAAAAAAAANNNNNNNGTACGT", 1),
    "only_best": ("dna", False, None, True, False, "search", b"ATCG",
                  b"CCCATCGCCCATCGCC", 1),
    "without_trace": ("dna", False, None, False, True, "search", b"ATCG",
                      b"CCCATCGCC", 0),
    "case_insensitive": ("dna", False, None, False, False, "search", b"atcg",
                         b"CCCATCGCC", 0),
    "iupac_r": ("iupac", False, None, False, False, "search", b"ART",
                b"CCAATCC", 0),
    "iupac_n": ("iupac", True, None, False, False, "search", b"ANT",
                b"CCAGTCC", 0),
}


def _configure(s, max_n_frac, only_best, without_trace):
    if max_n_frac is not None:
        s.set_max_n_frac(max_n_frac)
    if only_best:
        s.only_best_match()
    if without_trace:
        s.without_trace()
    return s


@pytest.mark.parametrize("engine", ["numpy", "xla"])
@pytest.mark.parametrize("name", sorted(BASIC))
def test_basic_examples_equal_reference(name, engine):
    prof, rc, nfrac, best, notrace, method, pat, text, k = BASIC[name]
    port = _configure(Searcher(prof, rc=rc, device="cpu"), nfrac, best,
                      notrace)
    ref = _configure(RefSearcher(prof, rc=rc, engine=engine), nfrac, best,
                     notrace)
    port_text = ref_text = text
    if name == "librs_rc_dna":
        port_text, ref_text = CachedRev(text, True), RefCachedRev(text, True)
    _same(getattr(port, method)(pat, port_text, k),
          getattr(ref, method)(pat, ref_text, k))


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


@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("method", ["search", "search_all"])
def test_golden_subset_equals_oracle(k, method):
    port = Searcher("iupac", rc=True, device="cpu")
    ref = RefSearcher("iupac", rc=True, engine="numpy")
    for pat in PATTERNS[:5]:
        for rec in RECORDS[:12]:
            _same(getattr(port, method)(pat, rec, k),
                  getattr(ref, method)(pat, rec, k))


@pytest.mark.parametrize("k", [1, 3])
def test_golden_subset_equals_xla_engine(k):
    port = Searcher("iupac", rc=True, device="cpu")
    ref = RefSearcher("iupac", rc=True, engine="xla")
    text = b"".join(RECORDS[:20])  # one longer text: several XLA tiles
    for pat in PATTERNS[2:6]:
        _same(port.search(pat, text, k), ref.search(pat, text, k))


def test_port_never_imports_jax(tmp_path):
    """Neither JAX nor any module of the JAX package is loaded by a search,
    a search_many and an overhang search on both engines, nor by
    ``python -m sassy_tpu_torch --device cpu search``."""
    fa = tmp_path / "reads.fa"
    fa.write_text(">r0\nCCCATCACCC\n>r1\nGGGTGATGGGAT\n")
    code = (
        "import runpy, sys\n"
        "from sassy_tpu_torch import Searcher, features\n"
        "s = Searcher('dna', rc=True, device='cpu')\n"
        "assert s.search(b'ATCG', b'CCCATCACCC', 1)\n"
        "assert s.search_many([b'ATCG'], [b'CCCATCACCC', b'AT'], 1)\n"
        "o = Searcher('iupac', rc=True, alpha=0.5, device='cpu')\n"
        "assert o.search(b'ATCGGA', b'GGACCCATCACCC', 1)\n"
        "assert o.search_many([b'ATCGGA'], [b'GGACCCATCACCC'], 1)\n"
        "features()\n"
        "sys.argv = ['sassy_tpu_torch', '--device', 'cpu', 'search', '-p',\n"
        f"            'ATCG', '-k', '1', {str(fa)!r}]\n"
        "try:\n"
        "    runpy.run_module('sassy_tpu_torch', run_name='__main__',\n"
        "                     alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "ref = [m for m in sys.modules\n"
        "       if m == 'sassy_tpu' or m.startswith('sassy_tpu.')]\n"
        "assert not ref, ref\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = proc.stdout.splitlines()
    assert rows[0].startswith("pat_id\t"), proc.stdout
    assert {r.split("\t")[1] for r in rows[1:]} == {"r0", "r1"}, proc.stdout


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Searcher("dna", device="cuda")


def test_kernel_build_failures_raise(monkeypatch, tmp_path):
    """No nvcc, or nvcc failing, raises with the compiler's output."""
    from sassy_tpu_torch.ops import myers_cuda

    monkeypatch.setattr(myers_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(myers_cuda, "nvcc_path", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        myers_cuda.build()
    bad = tmp_path / "nvcc"
    bad.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 3\n")
    bad.chmod(0o755)
    monkeypatch.setattr(myers_cuda, "nvcc_path", lambda: str(bad))
    with pytest.raises(RuntimeError, match="no such target"):
        myers_cuda.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_scan_kernel_takes_no_other_device():
    from sassy_tpu_torch.ops import myers_cuda, myers_torch

    win = myers_torch.Windows.of(torch.empty((3, 4, 8), dtype=torch.int32,
                                             device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        myers_cuda.scan_meta(win, *([None] * 6), 8, 8, 1, "iupac")


@pytest.mark.parametrize("build", ["new_fwd", "new_rc"])
def test_builders_make_the_port_searcher(build):
    s = getattr(Searcher, build)(profiles.Dna(), device="cpu")
    assert isinstance(s, Searcher) and s.rc == (build == "new_rc")
    assert s.search(b"ATCG", b"CCCATCACCC", 1)


@pytest.mark.parametrize("call", [
    lambda s: s.search_many([b"ACGT"], [b"ACGTACGT"], 1),
    lambda s: s.search_patterns([b"ACGT"], b"ACGTACGT", 1),
    lambda s: s.search_texts(b"ACGT", [b"ACGTACGT"], 1),
    lambda s: s.search_encoded_patterns(s.encode_patterns([b"ACGT"]),
                                        b"ACGTACGT", 1),
])
def test_batched_entry_points_equal_oracle(call):
    """The batched entry points (slice 2) run on the port's batched
    engine; tests/test_torch_batch.py covers them on the golden corpus."""
    got = call(Searcher("iupac", rc=True, device="cpu"))
    assert got
    _same(got, call(RefSearcher("iupac", rc=True, engine="numpy")))
