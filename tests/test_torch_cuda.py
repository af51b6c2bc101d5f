"""The q1meta CUDA kernel against its plain PyTorch version, and the
port's Searcher on the card against its CPU path and the numpy oracle.

Marked ``cuda``: every test skips without a CUDA device. On a GPU machine
without JAX, run them without the repository's conftest (which imports
JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sassy_tpu import Searcher as RefSearcher
from sassy_tpu_torch import Searcher, profiles
from sassy_tpu_torch.ops import myers_cuda, plan

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_inputs(eq_mode, M, T, NW, seed):
    """Kernel inputs with the reference's layouts: 0/all-ones masks (one
    plane per row for pure), pad rows at the top, 0/1 h deltas."""
    g = np.random.default_rng(seed)
    P = 9 if eq_mode == "ascii" else 4
    win = g.integers(0, 2**32, (NW, P, T), dtype=np.uint64).astype(np.uint32)
    if eq_mode == "ascii":
        win[:, :8] &= np.uint32(0x0F0F0F0F)  # small alphabet: rows match
    pm = np.zeros((M, P - 1 if eq_mode == "ascii" else P), np.uint32)
    if eq_mode == "pure":
        pm[np.arange(M), g.integers(0, 4, M)] = 0xFFFFFFFF
    else:
        pm[:] = np.where(g.random(pm.shape) < 0.4, 0xFFFFFFFF, 0)
    n_pad = int(g.integers(0, min(M, 8)))
    pm[:n_pad] = 0
    is_pad = np.zeros(M, np.uint32)
    is_pad[:n_pad] = 0xFFFFFFFF
    h_init = np.zeros(M, np.uint32)
    h_init[n_pad:] = g.integers(0, 2, M - n_pad)
    tile0 = g.random(T) < 0.3
    vf = np.where(tile0, -1, g.integers(0, 64, T)).astype(np.int32)
    vt = (vf + g.integers(0, NW * 32, T)).astype(np.int32)
    m_real = M - n_pad
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))  # noqa: E731
    return (as_t(win), torch.from_numpy(tile0), torch.from_numpy(vf),
            torch.from_numpy(vt), as_t(pm), as_t(is_pad), as_t(h_init),
            m_real, int(g.integers(0, m_real + 1)), int(g.integers(0, 8)),
            eq_mode)


@pytest.mark.parametrize("eq_mode", ["iupac", "pure", "ascii"])
@pytest.mark.parametrize("M", [8, 24, 40, 72, 192])
def test_kernel_equals_plain(cuda, eq_mode, M):
    args = _random_inputs(eq_mode, M, T=1000, NW=7, seed=M)
    dev_args = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    before = myers_cuda.scan_meta.launches
    got = myers_cuda.scan_meta(*dev_args)
    torch.cuda.synchronize()
    assert myers_cuda.scan_meta.launches == before + 1
    want = myers_cuda.scan_meta_plain(*args)
    for name, a, b in zip(("vp", "vm", "cost", "meta", "final"), got, want):
        assert torch.equal(a.cpu(), b), name


def test_kernel_rejects_bad_inputs(cuda):
    args = list(_random_inputs("iupac", 24, T=64, NW=3, seed=1))
    args = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError):
        myers_cuda.scan_meta(*args[:10], "ascii")  # 4 planes, not 9
    args[0] = args[0].transpose(0, 2).contiguous().transpose(0, 2)
    with pytest.raises(ValueError):
        myers_cuda.scan_meta(*args)  # not contiguous


def _planted_text(n, seed):
    """Random ACGT with an exact copy of a 23 bp pattern on each strand and
    a copy with one substitution."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    text = rng.choice(bases, n)
    pat = rng.choice(bases, 23)
    text[5000:5023] = pat
    text[n - 8000 : n - 7977] = np.frombuffer(
        profiles.Dna().reverse_complement(pat), np.uint8
    )
    text[n // 2 : n // 2 + 23] = pat
    text[n // 2 + 11] = ord("A") if pat[11] != ord("A") else ord("C")
    return pat, text


def _same(got, want):
    assert len(got) == len(want), (got, want)
    for a, b in zip(got, want):
        assert a.same_as(b), (a, b)
        assert str(a.cigar) == str(b.cigar), (a, b)


def test_searcher_cuda_equals_cpu(cuda, monkeypatch):
    pat, text = _planted_text(200_000, 7)
    gpu = Searcher("dna", rc=True, device="cuda")
    cpu = Searcher("dna", rc=True, device="cpu")
    for k in (0, 2):
        a = gpu.search(pat, text, k)
        with monkeypatch.context() as m:
            m.setattr(plan, "H100_TARGET_TILES", 64)  # a few wide tiles
            b = cpu.search(pat, text, k)
        _same(a, b)


@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("method", ["search", "search_all"])
def test_searcher_cuda_equals_oracle(cuda, method, k):
    pat, text = _planted_text(50_000, 11)
    got = getattr(Searcher("dna", rc=True, device="cuda"), method)(pat, text, k)
    want = getattr(RefSearcher("dna", rc=True, engine="numpy"), method)(
        pat, text, k
    )
    assert want
    _same(got, want)
