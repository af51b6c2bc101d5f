"""The CUDA scan kernels against their plain PyTorch versions: q1meta and
q2meta (and q2meta's pattern slices against q1meta), q1 and q2 (and q2's
slices against q1), every built member of the kernel-design family
(scan_qn, also against q2) and the four row-step ablations (full's vp
against q1's); and the port's Searcher on the card, single and batched,
with and without overhang, ascii, and with the suffix prefilter forced
on, against its CPU path and the numpy oracle.

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
from sassy_tpu_torch.ops import batch, minima, myers_cuda, plan

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_inputs(eq_mode, M, T, NW, seed, n_pad=None):
    """Kernel inputs with the reference's layouts: 0/all-ones masks (one
    plane per row for pure), pad rows at the top (``n_pad`` of them, else
    a random count), 0/1 h deltas."""
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
    n_rand = int(g.integers(0, min(M, 8)))
    n_pad = n_rand if n_pad is None else n_pad
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


def _random_q_inputs(eq_mode, Q, M, T, NW, seed):
    """Q patterns of one row bucket over shared windows: each pattern its
    own masks, pad rows (pattern q has q: its own m_real) and boundary
    cost."""
    parts = [_random_inputs(eq_mode, M, T, NW, seed + q, n_pad=q)
             for q in range(Q)]
    stack = lambda i: torch.stack([p[i] for p in parts])  # noqa: E731
    scal = lambda i: torch.tensor([p[i] for p in parts], dtype=torch.int32)  # noqa: E731
    return (*parts[0][:4], stack(4), stack(5), stack(6), scal(7), scal(8),
            parts[0][9], eq_mode)


@pytest.mark.parametrize("eq_mode", ["iupac", "pure", "ascii"])
@pytest.mark.parametrize("M", [24, 72])
def test_q_kernel_equals_plain_and_q1meta(cuda, eq_mode, M):
    args = _random_q_inputs(eq_mode, Q=3, M=M, T=1000, NW=7, seed=M)
    assert len(set(args[7].tolist())) > 1, "mixed m_real in one bucket"
    dev_args = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    before = myers_cuda.scan_q_meta.launches
    got = myers_cuda.scan_q_meta(*dev_args)
    torch.cuda.synchronize()
    assert myers_cuda.scan_q_meta.launches == before + 1
    want = myers_cuda.scan_q_meta_plain(*args)
    for name, a, b in zip(("vp", "vm", "cost", "meta", "final"), got, want):
        assert torch.equal(a.cpu(), b), name
    for q in range(3):
        one = myers_cuda.scan_meta(
            *dev_args[:4], dev_args[4][q], dev_args[5][q], dev_args[6][q],
            int(args[7][q]), int(args[8][q]), args[9], eq_mode,
        )
        for name, a, b in zip(("vp", "vm", "cost", "meta", "final"), one, got):
            assert torch.equal(a, b[q]), (q, name)


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


def _key(m):
    return m.sort_key(), m.cigar.to_string()


def _same(got, want):
    """Equal Match lists, field for field with the CIGAR string (the two
    packages' Match classes differ, so ``same_as`` cannot compare them)."""
    assert [_key(m) for m in got] == [_key(m) for m in want], (got, want)


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


def test_batched_search_cuda_equals_cpu_and_oracle(cuda):
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pats = [rng.choice(bases, 24) for _ in range(3)] + [rng.choice(bases, 20)]
    texts = [rng.choice(bases, int(n)) for n in rng.integers(0, 3000, 12)]
    for i, t in enumerate(texts):
        if len(t) > 100:
            p = pats[i % 4].copy()
            p[5] = ord("A") if p[5] != ord("A") else ord("C")
            t[40 : 40 + len(p)] = p
    texts[3] = profiles.Dna().reverse_complement(pats[1])
    gpu = Searcher("dna", rc=True, device="cuda")
    before = myers_cuda.scan_q_meta.launches
    got = gpu.search_many(pats, texts, 3)
    assert myers_cuda.scan_q_meta.launches > before
    assert got
    _same(got, Searcher("dna", rc=True, device="cpu").search_many(pats, texts, 3))
    _same(got, RefSearcher("dna", rc=True, engine="numpy").search_many(
        pats, texts, 3))


def _scan_args(args):
    """q1/q2's inputs from q1meta/q2meta's: without the owned range and k."""
    return (args[0], args[1], *args[4:9], args[10])


@pytest.mark.parametrize("eq_mode", ["iupac", "pure", "ascii"])
@pytest.mark.parametrize("M", [24, 120, 192])
def test_q1_kernel_equals_plain(cuda, eq_mode, M):
    args = _scan_args(_random_inputs(eq_mode, M, T=1000, NW=7, seed=M + 3))
    dev_args = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    before = myers_cuda.scan.launches
    got = myers_cuda.scan(*dev_args)
    torch.cuda.synchronize()
    assert myers_cuda.scan.launches == before + 1
    want = myers_cuda.scan_plain(*args)
    for name, a, b in zip(("vp", "vm", "cost"), got, want):
        assert torch.equal(a.cpu(), b), name


@pytest.mark.parametrize("eq_mode", ["iupac", "pure", "ascii"])
@pytest.mark.parametrize("M", [24, 120])
def test_q2_kernel_equals_plain_and_q1(cuda, eq_mode, M):
    Q = 3  # odd: the card takes any Q
    args = _scan_args(_random_q_inputs(eq_mode, Q, M, T=1000, NW=7, seed=M))
    dev_args = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    before = myers_cuda.scan_q.launches
    got = myers_cuda.scan_q(*dev_args)
    torch.cuda.synchronize()
    assert myers_cuda.scan_q.launches == before + 1
    want = myers_cuda.scan_q_plain(*args)
    for name, a, b in zip(("vp", "vm", "cost"), got, want):
        assert torch.equal(a.cpu(), b), name
    for q in range(Q):
        one = myers_cuda.scan(*dev_args[:2], dev_args[2][q], dev_args[3][q],
                              dev_args[4][q], int(args[5][q]),
                              int(args[6][q]), eq_mode)
        for name, a, b in zip(("vp", "vm", "cost"), one, got):
            assert torch.equal(a, b[q]), (q, name)


def test_q1_q2_reject_bad_inputs(cuda):
    args = list(_scan_args(_random_inputs("iupac", 24, T=64, NW=3, seed=1)))
    args = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError):
        myers_cuda.scan(*args[:7], "ascii")  # 4 planes, not 9
    with pytest.raises(ValueError):
        myers_cuda.scan_q(*args)  # one pattern's shapes, no pattern axis


def _overhung(seed, n, pat, hang):
    """Random ACGT text with the pattern hanging ``hang`` chars off its
    start and off its end, and its reverse complement inside."""
    rng = np.random.default_rng(seed)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
    m = len(pat)
    text[: m - hang] = pat[hang:]
    text[n - (m - hang) :] = pat[: m - hang]
    rc = np.frombuffer(profiles.Iupac().reverse_complement(pat), np.uint8)
    text[n // 2 : n // 2 + m] = rc
    return text


@pytest.mark.parametrize("m,k,alpha,kernel", [
    (23, 3, 0.5, "scan_meta"),  # word level: q1meta with the tail tile
    (120, 10, 0.1, "scan"),  # position level: q1
])
def test_overhang_search_cuda_equals_cpu_and_oracle(cuda, m, k, alpha,
                                                    kernel):
    pat = np.random.default_rng(m).choice(np.frombuffer(b"ACGT", np.uint8), m)
    text = _overhung(m, 60_000, pat, 4)
    gpu = Searcher("iupac", rc=True, alpha=alpha, device="cuda")
    fn = getattr(myers_cuda, kernel)
    before = fn.launches
    for method in ("search", "search_all"):
        got = getattr(gpu, method)(pat, text, k)
        _same(got, getattr(Searcher("iupac", rc=True, alpha=alpha,
                                    device="cpu"), method)(pat, text, k))
        _same(got, getattr(RefSearcher("iupac", rc=True, alpha=alpha,
                                       engine="numpy"), method)(pat, text, k))
    assert fn.launches >= before + 4
    assert any(mt.text_start == 0 for mt in got)


@pytest.mark.parametrize("m,k,alpha,kernel", [
    (24, 3, 0.5, "scan_q_meta"),
    (104, 10, 0.1, "scan_q"),
])
def test_batched_overhang_cuda_equals_cpu_and_oracle(cuda, m, k, alpha,
                                                     kernel):
    rng = np.random.default_rng(m)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pats = [rng.choice(bases, m) for _ in range(3)]
    texts = [_overhung(i, int(n), pats[i % 3], 3)
             for i, n in enumerate(rng.integers(2 * m, 3000, 10))]
    gpu = Searcher("iupac", rc=True, alpha=alpha, device="cuda")
    fn = getattr(myers_cuda, kernel)
    before = fn.launches
    got = gpu.search_many(pats, texts, k)
    assert fn.launches >= before + 2
    assert got
    _same(got, Searcher("iupac", rc=True, alpha=alpha,
                        device="cpu").search_many(pats, texts, k))
    _same(got, RefSearcher("iupac", rc=True, alpha=alpha,
                           engine="numpy").search_many(pats, texts, k))


def test_batched_position_level_sub_ranges_cuda(cuda, monkeypatch):
    """On the position-level path one q2 launch covers a dispatch chunk and
    its selection runs over tile sub-ranges; small budgets for both give
    the CPU path's and the oracle's Match lists."""
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pats = [rng.choice(bases, 104) for _ in range(3)]
    texts = [_overhung(i, int(n), pats[i % 3], 3)
             for i, n in enumerate(rng.integers(300, 3000, 10))]
    want = Searcher("iupac", rc=True, alpha=0.1, device="cpu").search_many(
        pats, texts, 10)
    ts = batch.TextSet(texts)
    (g,) = batch.BatchEngine("cpu").groups(
        profiles.Iupac(), [profiles.Iupac().encode(p) for p in pats], ts, 10,
        0.1)
    pp = ts.piece_plan(g.halo, g.w_chars, g.steps)
    # three pieces of all patterns per launch, one piece per selection
    monkeypatch.setattr(batch, "DISPATCH_BYTES", 12 * pp.NW * g.Q * 3)
    monkeypatch.setattr(minima, "POSITIONS_PER_CHUNK", 1)
    n_chunks = len(list(batch.BatchEngine.chunks(g, pp)))
    assert not g.fast and n_chunks >= 3
    before = myers_cuda.scan_q.launches
    got = Searcher("iupac", rc=True, alpha=0.1, device="cuda").search_many(
        pats, texts, 10)
    assert myers_cuda.scan_q.launches == before + 2 * n_chunks  # 2 strands
    assert got
    _same(got, want)
    _same(got, RefSearcher("iupac", rc=True, alpha=0.1,
                           engine="numpy").search_many(pats, texts, 10))


def _qn_members(M):
    members = [(U, False, 1) for U in myers_cuda.QN_LOOP_U]
    if M in myers_cuda.QN_UNROLL_ROWS:
        members += [(U, True, WU) for U, WU in myers_cuda.QN_UNROLL]
    return members


@pytest.mark.parametrize("M", [24, 64, 40])
def test_qn_family_equals_plain_and_q2(cuda, M):
    """Every built iupac member: the rows kept for U = 1, 2, 4, 8 at any
    M <= 64, unrolled at the built row counts."""
    Q, NW = 8, 8
    args = _scan_args(_random_q_inputs("iupac", Q, M, T=1000, NW=NW, seed=M))
    dev_args = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    want = myers_cuda.scan_qn_plain(*args)
    q2 = myers_cuda.scan_q(*dev_args)
    for U, unroll, WU in _qn_members(M):
        before = myers_cuda.scan_qn.launches
        got = myers_cuda.scan_qn(*dev_args, U, unroll, WU)
        torch.cuda.synchronize()
        assert myers_cuda.scan_qn.launches == before + 1
        for name, a, b, c in zip(("vp", "vm", "cost"), got, want, q2):
            assert torch.equal(a.cpu(), b), (U, unroll, WU, name)
            assert torch.equal(a, c), (U, unroll, WU, name)


@pytest.mark.parametrize("eq_mode", ["iupac", "pure", "ascii"])
def test_qn_one_pattern_per_thread_takes_every_eq(cuda, eq_mode):
    args = _scan_args(_random_q_inputs(eq_mode, 3, 56, T=700, NW=5, seed=9))
    dev_args = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    got = myers_cuda.scan_qn(*dev_args)
    for name, a, b in zip(("vp", "vm", "cost"), got,
                          myers_cuda.scan_qn_plain(*args)):
        assert torch.equal(a.cpu(), b), name


def test_qn_rejects_what_is_not_built(cuda):
    args = _scan_args(_random_q_inputs("ascii", 4, 24, T=64, NW=4, seed=1))
    args = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="not built"):
        myers_cuda.scan_qn(*args, U=2)  # ascii: one pattern per thread only
    args = _scan_args(_random_q_inputs("iupac", 4, 32, T=64, NW=4, seed=1))
    args = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="not built"):
        myers_cuda.scan_qn(*args, U=2, unroll=True)  # rows 24 and 64 only
    with pytest.raises(ValueError, match="WU = 3"):
        myers_cuda.scan_qn(*args, WU=3)


@pytest.mark.parametrize("variant", ["full", "noeq", "nomem", "nostore"])
@pytest.mark.parametrize("M", [24, 64, 7])
def test_variant_equals_plain(cuda, variant, M):
    g = np.random.default_rng(M)
    as_t = lambda a: torch.from_numpy(a.astype(np.uint32).view(np.int32))  # noqa: E731
    win = as_t(g.integers(0, 2**32, (9, 4, 1000), dtype=np.uint64))
    pm = as_t(g.integers(0, 2**32, (M, 4), dtype=np.uint64))
    before = myers_cuda.scan_variant.launches
    got = myers_cuda.scan_variant(win.to(cuda), pm.to(cuda), variant)
    torch.cuda.synchronize()
    assert myers_cuda.scan_variant.launches == before + 1
    assert torch.equal(got.cpu(), myers_cuda.scan_variant_plain(win, pm,
                                                               variant))
    if variant == "full":
        zeros = torch.zeros(M, dtype=torch.int32, device=cuda)
        vp = myers_cuda.scan(
            win.to(cuda), torch.zeros(1000, dtype=torch.bool, device=cuda),
            pm.to(cuda), zeros, torch.ones_like(zeros), M, M, "iupac")[0]
        assert torch.equal(got, vp)


@pytest.mark.parametrize("case_sensitive", [True, False])
def test_ascii_search_cuda_equals_cpu_and_oracle(cuda, case_sensitive):
    from sassy_tpu import profiles as ref_profiles

    rng = np.random.default_rng(3)
    text = rng.integers(32, 127, 40_000).astype(np.uint8)
    text[rng.integers(0, len(text), 50)] = 0xFF
    pat = np.frombuffer(b"Needle in a Haystack", np.uint8)
    text[100:120] = pat
    text[20_000:20_020] = np.frombuffer(b"needle in a haystack", np.uint8)
    text[39_980:] = np.frombuffer(b"Needle in\xffa Haystack", np.uint8)
    prof = profiles.Ascii(case_sensitive=case_sensitive)
    ref = RefSearcher(ref_profiles.Ascii(case_sensitive=case_sensitive),
                      engine="numpy")
    gpu, cpu = Searcher(prof, device="cuda"), Searcher(prof, device="cpu")
    before = myers_cuda.scan_meta.launches
    on_card = {fn: getattr(gpu, fn)(pat, text, 2)
               for fn in ("search", "search_all")}
    assert myers_cuda.scan_meta.launches == before + 2
    for method, got in on_card.items():
        assert len(got) >= 2 + (not case_sensitive)
        _same(got, getattr(cpu, method)(pat, text, 2))
        _same(got, getattr(ref, method)(pat, text, 2))
    texts = [text[:3000], text[19_000:23_000], text[39_000:], b"needle"]
    pats = [pat, np.frombuffer(b"HAYSTACK", np.uint8)]
    before = myers_cuda.scan_q_meta.launches
    got = gpu.search_many(pats, texts, 2)
    # one launch per row bucket (20 and 8 bytes)
    assert myers_cuda.scan_q_meta.launches == before + 2 and got
    _same(got, cpu.search_many(pats, texts, 2))
    _same(got, ref.search_many(pats, texts, 2))


def test_single_prefilter_cuda_equals_cpu_and_oracle(cuda, monkeypatch):
    rng = np.random.default_rng(8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    text = rng.choice(bases, 120_000)
    pat = rng.choice(bases, 80)
    mut = pat.copy()
    mut[30] = ord("A") if mut[30] != ord("A") else ord("C")
    rc = np.frombuffer(profiles.Iupac().reverse_complement(pat), np.uint8)
    for off, seq in ((0, pat), (511 * 2, mut), (60_000, rc), (119_920, mut)):
        text[off : off + 80] = seq
    gpu = Searcher("iupac", rc=True, device="cuda")
    off_ = gpu.search(pat, text, 3)
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", 0)
    before = myers_cuda.scan_meta.launches
    on_card = {fn: getattr(gpu, fn)(pat, text, 3)
               for fn in ("search", "search_all")}
    assert myers_cuda.scan_meta.launches == before + 8  # suffix + flagged
    _same(on_card["search"], off_)
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", 1 << 62)
    for method, on in on_card.items():
        assert len(on) >= 4
        _same(on, getattr(Searcher("iupac", rc=True, device="cpu"), method)(
            pat, text, 3))
        _same(on, getattr(RefSearcher("iupac", rc=True, engine="numpy"),
                          method)(pat, text, 3))
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", 0)
    # no flagged tile: no second launch
    before = myers_cuda.scan_meta.launches
    assert gpu.search(pat, rng.choice(bases, 30_000), 3) == []
    assert myers_cuda.scan_meta.launches == before + 2


def test_batched_prefilter_cuda_equals_cpu_and_oracle(cuda, monkeypatch):
    rng = np.random.default_rng(12)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pats = [rng.choice(bases, 72 - q) for q in range(3)]
    texts = [rng.choice(bases, int(n)) for n in rng.integers(50, 6000, 14)]
    rc = lambda p: np.frombuffer(  # noqa: E731
        profiles.Iupac().reverse_complement(p), np.uint8)
    for i, t in enumerate(texts):
        if len(t) > 200 and i % 3:
            p = pats[i % 3].copy()
            p[9] = ord("A") if p[9] != ord("A") else ord("C")
            t[len(t) - 100 - len(p) : len(t) - 100] = p if i % 2 else rc(p)
    gpu = Searcher("iupac", rc=True, device="cuda")
    off_ = gpu.search_many(pats, texts, 2)
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", 0)
    monkeypatch.setattr(plan, "H100_TARGET_TILES", 3 * 200)
    before = myers_cuda.scan_q_meta.launches
    on = gpu.search_many(pats, texts, 2)
    assert myers_cuda.scan_q_meta.launches == before + 4  # suffix + flagged
    assert len(on) >= 4
    _same(on, off_)
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", 1 << 62)
    _same(on, Searcher("iupac", rc=True, device="cpu").search_many(
        pats, texts, 2))
    _same(on, RefSearcher("iupac", rc=True, engine="numpy").search_many(
        pats, texts, 2))
