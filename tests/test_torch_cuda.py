"""The CUDA scan kernels against their plain PyTorch versions: q1meta and
q2meta (and q2meta's pattern slices against q1meta), q1 and q2 (and q2's
slices against q1), every built member of the kernel-design family
(scan_qn, also against q2) and the four row-step ablations (full's vp
against q1's); the text pack kernel against ``pack_plain`` (the four
pack descriptors, every nb, unaligned inputs, the three engines' calls,
its refusals); the text set's pack kernel against ``pack_set_plain``
(the four descriptors, both strands, overshoot steps, three layouts of
the bytes, 50,000 texts of 1-3 words and one of 2 MB, ``TextSet.planes``'
one launch a strand, its refusals); the single engine's two strands from
one upload (``prepare_strands``: the reverse strand equal to the pack of
the flipped bytes; a second search of a read-only array packs nothing);
the port's Searcher on the card, single and batched, with and without
overhang, ascii, and with the suffix prefilter forced on, against its
CPU path and the numpy oracle; and the host finish's traceback kernel
(``myers_cuda.trace_windows``) against ``traceback.trace_plain`` on the
same planes (every profile, both strands, overhang, 8-120 bp, chunked;
at the Myers words' edges: patterns of 31-65 and 200 bp, windows of 31-33
positions at every offset modulo 32; a 500 bp pattern at k = 50, also
chunked by a small ``FILL_BYTES``), through both engines' finish, on a
forced walk failure and on inputs it refuses.

Marked ``cuda``: every test skips without a CUDA device. On a GPU machine
without JAX, run them without the repository's conftest (which imports
JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from sassy_tpu import Searcher as RefSearcher
from sassy_tpu_torch import Searcher, profiles, semantics, traceback
from sassy_tpu_torch.ops import batch, minima, myers_cuda, myers_torch, plan
from sassy_tpu_torch.ops.myers_torch import Windows

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
    args = _described(_random_inputs(eq_mode, M, T=1000, NW=7, seed=M))
    dev_args = _to(cuda, args)
    before = myers_cuda.scan_meta.launches
    got = myers_cuda.scan_meta(*dev_args)
    torch.cuda.synchronize()
    assert myers_cuda.scan_meta.launches == before + 1
    want = myers_cuda.scan_meta_plain(*args)
    for name, a, b in zip(("vp", "vm", "cost", "meta", "final"), got, want):
        assert torch.equal(a.cpu(), b), name


def _described(args):
    """``args`` with their window tensor (the first) described by
    ``Windows.of``: how the four scan entry points take windows."""
    return (Windows.of(args[0]), *args[1:])


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
    args = _described(_random_q_inputs(eq_mode, Q=3, M=M, T=1000, NW=7,
                                       seed=M))
    assert len(set(args[7].tolist())) > 1, "mixed m_real in one bucket"
    dev_args = _to(cuda, args)
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
    args = list(_to(cuda, _described(
        _random_inputs("iupac", 24, T=64, NW=3, seed=1))))
    with pytest.raises(ValueError):
        myers_cuda.scan_meta(*args[:10], "ascii")  # 4 planes, not 9
    planes = args[0].planes
    args[0] = replace(args[0], planes=planes.t().contiguous().t())
    with pytest.raises(ValueError):
        myers_cuda.scan_meta(*args)  # not contiguous
    with pytest.raises(TypeError):
        myers_cuda.scan_meta(args[0].gather(), *args[1:])  # not described


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
    args = _described(_scan_args(_random_inputs(eq_mode, M, T=1000, NW=7,
                                                seed=M + 3)))
    dev_args = _to(cuda, args)
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
    args = _described(_scan_args(_random_q_inputs(eq_mode, Q, M, T=1000,
                                                  NW=7, seed=M)))
    dev_args = _to(cuda, args)
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
    args = list(_to(cuda, _described(
        _scan_args(_random_inputs("iupac", 24, T=64, NW=3, seed=1)))))
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
    """On the position-level path one q2 launch covers a dispatch chunk,
    and on the card so does one selection call (the chain inside the
    kernel), whatever the CPU path's sub-range budget; small budgets for
    both give the CPU path's and the oracle's Match lists."""
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pats = [rng.choice(bases, 104) for _ in range(3)]
    texts = [_overhung(i, int(n), pats[i % 3], 3)
             for i, n in enumerate(rng.integers(300, 3000, 10))]
    want = Searcher("iupac", rc=True, alpha=0.1, device="cpu").search_many(
        pats, texts, 10)
    ts = batch.TextSet(texts, cuda)
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
    selects = myers_cuda.select_positions_tiles.launches
    got = Searcher("iupac", rc=True, alpha=0.1, device="cuda").search_many(
        pats, texts, 10)
    assert myers_cuda.scan_q.launches == before + 2 * n_chunks  # 2 strands
    assert (myers_cuda.select_positions_tiles.launches
            == selects + 2 * n_chunks)
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
    q2 = myers_cuda.scan_q(*_described(dev_args))
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
            Windows.of(win.to(cuda)), torch.zeros(1000, dtype=torch.bool, device=cuda),
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


def _sharded_launches():
    return (myers_cuda.scan_meta.launches, myers_cuda.scan_q_meta.launches,
            myers_cuda.scan.launches, myers_cuda.scan_q.launches)


@pytest.mark.parametrize("n_text,n_pat", [(1, 1), (8, 1), (4, 2)])
@pytest.mark.parametrize("alpha", [None, 0.5])
def test_sharded_cuda_equals_single_engine(cuda, n_text, n_pat, alpha):
    """The sharded search's slots on one card (1 and 8 slots, and a 2-group
    pattern axis) against the card's single engine, with copies planted
    across every shard edge and off both text ends; word level through
    q1meta / q2meta only, overhang through q1 / q2 only."""
    from sassy_tpu_torch.ops.myers_torch import TorchEngine
    from sassy_tpu_torch.parallel import ShardedSearch, make_mesh

    rng = np.random.default_rng(70 + n_text)
    bases = np.frombuffer(b"ACGT", np.uint8)
    n, m = 200_000 + 37, 23
    Q = 1 if n_text == 8 else 4  # one pattern a slot: q1meta / q1
    pats = [rng.choice(bases, m) for _ in range(Q)]
    text = rng.choice(bases, n)
    span = n // n_text
    for d in range(1, n_text):
        text[d * span - 10 : d * span - 10 + m] = pats[d % Q]
    text[:19] = pats[0][4:]
    text[-19:] = pats[-1][:19]
    prof = profiles.Iupac()
    ss = ShardedSearch(mesh=make_mesh(n_text, n_pat))
    before = _sharded_launches()
    got = ss.candidates_batch(prof, pats, text, 3, alpha=alpha)
    torch.cuda.synchronize()
    q1meta, q2meta, q1, q2 = (a - b for a, b in
                              zip(_sharded_launches(), before))
    used = {(None, 1): q1meta, (None, 4): q2meta, (0.5, 1): q1,
            (0.5, 4): q2}[alpha, Q]
    assert used == n_text * n_pat
    assert q1meta + q2meta + q1 + q2 == used
    eng = TorchEngine("cuda")
    want = [eng.candidates(prof, prof.encode(p), text, 3, alpha, None, False)
            for p in pats]
    assert got == want
    assert ss.last_stats["ownership_violations"] == 0
    assert sum(len(c) for c in got) == ss.last_stats["per_shard_counts"].sum()


# ---------------------------------------------------------------------------
# the selection kernels (csrc/select_words.cu, csrc/select_positions.cu)
# against their plain versions


def _lexsorted(cols):
    """(R, N) columns on the host in lexicographic order."""
    a = cols.cpu().numpy()
    return a[:, np.lexsort(a[::-1])]


def _to(dev, args):
    """The arguments on ``dev``: tensors moved, a window descriptor's
    planes and tables with them."""
    return tuple(a.to(dev) if isinstance(a, torch.Tensor)
                 else _desc_to(dev, a) if isinstance(a, Windows) else a
                 for a in args)


def _desc_to(dev, win):
    return Windows(win.planes.to(dev), win.wstart.to(dev), win.wend.to(dev),
                   win.NW)


def _piece_tables(g, T, NW, base):
    """Piece tables of the batched engine's layout: valid_from, valid_to,
    text_end, islast_at, pos_base (from ``base``, past 2^31 at most)."""
    tile0 = g.random(T) < 0.3
    vf = np.where(tile0, -1, g.integers(0, 64, T)).astype(np.int32)
    vt = np.minimum(vf + g.integers(32, NW * 32, T), NW * 32 - 32)
    tend = (vt - g.integers(0, 60, T)).astype(np.int64)
    islast = np.where(g.random(T) < 0.5, vt, -1).astype(np.int32)
    pos_base = base + np.arange(T, dtype=np.int64) * (NW * 32 + 1)
    t = torch.from_numpy
    return (t(tile0), t(vf), t(vt.astype(np.int32)), t(tend), t(islast),
            t(pos_base))


def _held(cuda, entry, args, counter):
    """The entry point on the card (one kernel call) against its plain
    version on the host, equal after a lexsort; returns N."""
    before = counter.launches
    got = getattr(minima, entry)(*_to(cuda, args))
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int64
    want = getattr(minima, entry + "_plain")(*args)
    assert got.shape == want.shape
    np.testing.assert_array_equal(_lexsorted(got), _lexsorted(want))
    return want.shape[1]


@pytest.mark.parametrize("overhang", [False, True])
@pytest.mark.parametrize("all_minima", [False, True])
@pytest.mark.parametrize("Q", [1, 8])
def test_select_words_kernel_equals_plain(cuda, Q, all_minima, overhang):
    """Random q2meta outputs over piece tables past 2^31, with and without
    text ends and a three-word strip."""
    T, NW, k = 400, 9, 6
    g = np.random.default_rng(Q + 2 * all_minima + 4 * overhang)
    tile0, vf, vt, tend, islast, pos_base = _piece_tables(g, T, NW, 3 << 30)
    a = _random_q_inputs("iupac", Q, 24, T=T, NW=NW, seed=Q)
    vp, vm, cost, meta, _ = myers_cuda.scan_q_meta_plain(
        Windows.of(a[0]), tile0, vf, vt, *a[4:9], k, "iupac")
    state0 = torch.from_numpy(g.integers(0, 2, (Q, T)).astype(np.int32))
    args = (vp, vm, cost, meta, vf, vt, islast, pos_base, k, state0,
            all_minima, tend if overhang else None, 0.3 if overhang else None,
            3 if overhang else 0)
    assert _held(cuda, "select_words_tiles_q", args, myers_cuda.select_words)
    # tile slices, as BatchEngine.select passes a range of a chunk
    part = tuple(x[..., 50:300] if isinstance(x, torch.Tensor)
                 and x.shape[-1] == T else x for x in args)
    _held(cuda, "select_words_tiles_q", part, myers_cuda.select_words)


def _position_level(monkeypatch, alpha=0.1, k=10):
    """A position-level single search's q1 outputs on the host."""
    from sassy_tpu_torch.ops.myers_torch import TorchEngine

    monkeypatch.setattr(plan, "H100_TARGET_TILES", 8)
    prof = profiles.Iupac()
    g = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pat = g.choice(bases, 120)
    text = _overhung(3, 2500, pat, 10)
    eng = TorchEngine("cpu")
    inp = eng.build_inputs(prof, prof.encode(pat), text, k, alpha, None,
                           False)
    assert not inp.fast
    return inp, eng.scan(inp)


@pytest.mark.parametrize("all_minima", [False, True])
@pytest.mark.parametrize("owned", [None, (0, None, 0), (900, 4000, 1),
                                   (900, 4000, 0), (1700, None, 1)])
def test_select_positions_kernel_equals_plain(cuda, monkeypatch, owned,
                                              all_minima):
    """One text's positions, alone and with the sharded search's owned
    range and incoming state."""
    inp, (vp, vm, cost) = _position_level(monkeypatch)
    args = (vp, vm, cost, inp.W, inp.halo, inp.boundary_m, inp.n_text,
            inp.max_pos, inp.k, 0.1, all_minima)
    if owned is not None:
        args += owned
    n = _held(cuda, "select_candidates", args, myers_cuda.select_positions)
    assert n or owned == (1700, None, 1)


@pytest.mark.parametrize("all_minima", [False, True])
@pytest.mark.parametrize("alpha", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("Q", [1, 8])
def test_select_positions_tiles_kernel_equals_plain(cuda, Q, alpha,
                                                    all_minima):
    """Q patterns over pieces past 2^31, also over a range of tiles."""
    T, NW, k = 300, 5, 8
    g = np.random.default_rng(Q + int(10 * alpha))
    tile0, vf, vt, tend, islast, pos_base = _piece_tables(g, T, NW, 5 << 30)
    a = _random_q_inputs("iupac", Q, 24, T=T, NW=NW, seed=Q + 20)
    vp, vm, cost = myers_cuda.scan_q_plain(Windows.of(a[0]), tile0, *a[4:9],
                                           "iupac")
    boundary0 = torch.where(tile0[None], a[8][:, None], a[7][:, None])
    state0 = torch.from_numpy(g.integers(0, 2, (Q, T)).astype(np.int32))
    args = (vp, vm, cost, boundary0, tend, vf, vt, islast, pos_base, k,
            alpha, state0, all_minima)
    assert _held(cuda, "select_candidates_tiles", args,
                 myers_cuda.select_positions_tiles)
    part = tuple(x[..., 40:200] if isinstance(x, torch.Tensor)
                 and x.shape[-1] == T else x for x in args)
    _held(cuda, "select_candidates_tiles", part,
          myers_cuda.select_positions_tiles)


def test_select_kernels_on_empty_results(cuda, monkeypatch):
    """No candidate (k below every cost): each kernel returns its empty
    columns; no tile at all: no launch."""
    T, NW = 64, 4
    g = np.random.default_rng(9)
    tile0, vf, vt, tend, islast, pos_base = _piece_tables(g, T, NW, 0)
    a = _random_q_inputs("iupac", 2, 24, T=T, NW=NW, seed=9)
    vp, vm, cost, meta, _ = myers_cuda.scan_q_meta_plain(
        Windows.of(a[0]), tile0, vf, vt, *a[4:9], 6, "iupac")
    state0 = torch.zeros((2, T), dtype=torch.int32)
    words = (vp, vm, cost, meta, vf, vt, islast, pos_base, -1, state0, True)
    assert _held(cuda, "select_words_tiles_q", words,
                 myers_cuda.select_words) == 0
    inp, (pv, pm, pc) = _position_level(monkeypatch)
    assert _held(cuda, "select_candidates",
                 (pv, pm, pc, inp.W, inp.halo, inp.boundary_m, inp.n_text,
                  inp.max_pos, -1, 0.1, False),
                 myers_cuda.select_positions) == 0
    boundary0 = torch.full((2, T), 99, dtype=torch.int32)
    assert _held(cuda, "select_candidates_tiles",
                 (vp, vm, cost, boundary0, tend, vf, vt, islast, pos_base,
                  -1, 0.1, state0, False),
                 myers_cuda.select_positions_tiles) == 0
    before = (myers_cuda.select_words.launches,
              myers_cuda.select_positions.launches,
              myers_cuda.select_positions_tiles.launches)
    none = tuple(x[..., :0].to(cuda) if isinstance(x, torch.Tensor)
                 else x for x in words)
    assert myers_cuda.select_words(*none).shape == (4, 0)
    assert (myers_cuda.select_words.launches,
            myers_cuda.select_positions.launches,
            myers_cuda.select_positions_tiles.launches) == before


def test_select_kernels_reject_bad_inputs(cuda):
    """Inputs of another dtype, shape, layout or device raise ValueError
    before any launch."""
    T, NW = 32, 3
    g = np.random.default_rng(4)
    tile0, vf, vt, tend, islast, pos_base = _piece_tables(g, T, NW, 0)
    a = _random_q_inputs("iupac", 2, 24, T=T, NW=NW, seed=4)
    outs = myers_cuda.scan_q_meta_plain(Windows.of(a[0]), tile0, vf, vt,
                                        *a[4:9], 6, "iupac")[:4]
    state0 = torch.zeros((2, T), dtype=torch.int32)
    good = _to(cuda, (*outs, vf, vt, islast, pos_base, 6, state0, False))
    bad = {
        0: good[0].to(torch.int64),                # vp of another dtype
        3: good[3][:, :, :-1].contiguous(),        # meta of another shape
        7: good[7].to(torch.int32),                # pos_base as int32
        9: good[9][:1],                            # one pattern's seeds
    }
    for i, x in bad.items():
        args = list(good)
        args[i] = x
        with pytest.raises(ValueError):
            myers_cuda.select_words(*args)
    vp, vm, cost = (x[0] for x in good[:3])
    with pytest.raises(ValueError, match="do not fit"):
        myers_cuda.select_positions(vp, vm, cost, NW, 1, 0, 100, 100, 3,
                                    None, False)
    # the position level reads its words in place: tiles adjacent
    other = good[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="strides"):
        myers_cuda.select_positions_tiles(
            *good[:2], other, good[9], tend.to(cuda), *good[4:8], 3, 0.1,
            good[9], False)
    with pytest.raises(ValueError, match="text_end"):
        myers_cuda.select_positions_tiles(
            *good[:3], good[9], tend.to(cuda).to(torch.int32), *good[4:8], 3,
            0.1, good[9], False)
    # a CUDA tensor beside a host one
    with pytest.raises(ValueError):
        myers_cuda.select_words(*good[:4], vf, *good[5:])


def _sparse_words(g, shape, k, dev):
    """Random vp, vm (few bits, never both) and the running costs a scan
    gives them ((..., NW, T) int32 on ``dev``): each word's start cost is
    the one before plus popc(vp) - popc(vm), from a start near k."""
    def bits():
        return g.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    vp = bits() & bits() & bits()
    vm = bits() & bits() & bits() & ~vp
    pc = lambda x: np.unpackbits(  # noqa: E731
        x.view(np.uint8).reshape(*x.shape, 4), axis=-1).sum(-1)
    step = (pc(vp).astype(np.int64) - pc(vm))
    start = g.integers(k - 4, k + 12, shape[:-2] + (1,) + shape[-1:])
    cost = start + np.concatenate(
        [np.zeros_like(step[..., :1, :]), np.cumsum(step, -2)[..., :-1, :]],
        -2)
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a).view(np.int32)).to(dev)
    return t(vp), t(vm), t(cost.astype(np.int32))


def _chained_pieces(cuda, Q, T, NW, k, alpha, seed, starts):
    """Q patterns over T pieces on the card: select_candidates_chained's
    arguments but the carry, past 2^31."""
    g = np.random.default_rng(seed)
    tile0, vf, vt, tend, islast, pos_base = _piece_tables(g, T, NW, 5 << 30)
    tile0 = torch.from_numpy(g.random(T) < starts)
    vf = torch.where(tile0, -1, vf.clamp(min=0))
    vp, vm, cost = _sparse_words(g, (Q, NW, T), k, cuda)
    boundary0 = cost[:, 0].clone()
    return _to(cuda, (vp, vm, cost, boundary0, tend, vf, vt, islast,
                      pos_base, k, alpha, tile0))


#: (Q, T, NW, k, alpha, all_minima, starts): T not a multiple of the
#: block, a chain across more blocks than the scan block has threads,
#: resets in the middle, words past the text end (alpha), no candidate,
#: every word skipped but the few that reach k
CHAIN_CASES = [(3, 1000, 5, 8, 0.1, False, 0.05),
               (8, 40_000, 3, 8, 0.5, False, 0.01),
               (8, 40_000, 3, 8, 0.5, True, 0.01),
               (1, 300_000, 2, 6, 0.0, False, 0.0),
               (4, 777, 4, 6, 1.0, False, 0.3),
               (3, 1000, 5, -50, 0.1, False, 0.05),
               (3, 1000, 5, 0, 0.1, False, 0.05)]


@pytest.mark.parametrize("case", CHAIN_CASES)
def test_select_positions_chained_kernel_equals_plain(cuda, case,
                                                      monkeypatch):
    """The pieces' kernel with the chain inside (is_start, carry in and
    out) against select_candidates_chained_plain on the same CUDA
    tensors, columns in the same order and carry out equal; at most three
    launches, one host read, and neither tile_state_chain_codes nor
    last_delta_codes."""
    import warnings

    Q, T, NW, k, alpha, all_minima, starts = case
    args = _chained_pieces(cuda, Q, T, NW, k, alpha, Q + T, starts)
    carry = torch.where(torch.arange(Q, device=cuda)[:, None] % 2 == 0, 3,
                        0).to(torch.int32)
    want, want_carry = minima.select_candidates_chained_plain(
        *args, carry, all_minima)

    def refuse(*a, **kw):
        raise AssertionError("the chain runs in the kernel")

    monkeypatch.setattr(minima, "tile_state_chain_codes", refuse)
    monkeypatch.setattr(minima, "last_delta_codes", refuse)
    before = (myers_cuda.select_positions_tiles.launches,
              myers_cuda.select_positions_tiles.passes)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got, got_carry = minima.select_candidates_chained(
                *args, carry, all_minima)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches, passes = (myers_cuda.select_positions_tiles.launches,
                        myers_cuda.select_positions_tiles.passes)
    assert launches == before[0] + 1 and passes - before[1] <= 3
    syncs = [str(w.message) for w in seen
             if str(w.message).startswith("called a synchronizing")]
    assert len(syncs) == 1, [str(w.message) for w in seen]
    assert got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(got_carry, want_carry)
    assert want.shape[1] or k < 0


@pytest.mark.parametrize("owned", [None, (1_000_000, 30_000_000, 1),
                                   (1_000_000, 30_000_000, 0),
                                   (25_000_000, None, 1)])
@pytest.mark.parametrize("all_minima", [False, True])
def test_select_positions_many_tiles_kernel_equals_plain(cuda, owned,
                                                         all_minima):
    """One text of 300,001 tiles (more blocks than the scan block has
    threads, not a multiple of the block), positions past the text end,
    the sharded owned range and incoming state: the kernel against
    select_candidates_plain on the same CUDA tensors, in the same order,
    in at most three launches."""
    g = np.random.default_rng(11)
    W, halo, T, k = 4, 1, 300_001, 6
    vp, vm, cost = _sparse_words(g, (W + halo + 1, T), k, cuda)
    n_text = T * W * 32 - 500
    args = (vp, vm, cost, W, halo, 7, n_text, n_text + 100, k, 0.3,
            all_minima) + (owned or ())
    want = minima.select_candidates_plain(*args)
    passes = myers_cuda.select_positions.passes
    got = minima.select_candidates(*args)
    assert myers_cuda.select_positions.passes - passes <= 3
    assert got.shape == want.shape and want.shape[1]
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the word-level selection with the state chain inside, and q2meta at a
# width the dispatch bound caps


def _chained_words(Q, T, NW, k, seed, starts=0.3, overhang=False,
                   quiet=0.2):
    """Random scan outputs on the host (sparse deltas, running costs near
    k; a share ``quiet`` of the tiles without a delta) with their meta and
    final codes, and piece tables: ``minima.select_words_chained``'s
    arguments, the carry None."""
    g = np.random.default_rng(seed)
    vp, vm, cost = _sparse_words(g, (Q, NW, T), k, "cpu")
    keep = torch.from_numpy(g.random((1, 1, T)) >= quiet)
    vp, vm = vp * keep, vm * keep
    _, vf, vt, tend, islast, pos_base = _piece_tables(g, T, NW, 0)
    tile0 = torch.from_numpy(g.random(T) < starts)
    vf = torch.where(tile0, -1, vf.clamp(min=0))
    meta, final = minima.meta_from_words(vp, vm, cost, vf, vt, k)
    return [vp, vm, cost, meta, final, tile0, None, vf, vt, islast,
            pos_base, k, False, tend if overhang else None,
            0.3 if overhang else None, 3 if overhang else 0]


def _word_carry(kind, Q):
    """The code entering tile 0: none (the single engine), the batched
    carry (3 up, 0) or the sharded seed (2 + sign)."""
    if kind is None:
        return None
    codes = {"carry": (3, 0), "seed": (3, 2)}[kind]
    return torch.tensor([[codes[q % 2]] for q in range(Q)], dtype=torch.int32)


#: (Q, T, NW, k, starts, overhang, all_minima, carry, quiet): the single
#: engine's shape (one pattern, a text start at tile 0 only, rows of many
#: tile chunks), the batched engine's (pieces with text starts, a carry
#: in), the sharded engine's (a seed, no start), tiles without a delta
WORDS_CASES = [(1, 300_000, 3, 5, 0.0, False, False, None, 0.3),
               (1, 20_000, 4, 5, 0.0, True, False, None, 0.9),
               (8, 9_000, 6, 5, 0.1, False, False, "carry", 0.2),
               (8, 9_000, 6, 5, 0.1, True, True, "carry", 0.2),
               (96, 300, 9, 5, 0.5, False, False, "carry", 0.1),
               (4, 5_000, 5, 5, 0.0, False, False, "seed", 0.9),
               (2, 1_000, 3, 5, 0.0, True, False, "seed", 0.5)]


def _words_case(case):
    Q, T, NW, k, starts, overhang, all_minima, kind, quiet = case
    args = _chained_words(Q, T, NW, k, Q + T + NW, starts, overhang, quiet)
    args[6] = _word_carry(kind, Q)
    args[12] = all_minima
    if kind is None:
        args[5][0] = True
    return args


@pytest.mark.parametrize("case", WORDS_CASES)
def test_select_words_chained_kernel_equals_plain(cuda, case, monkeypatch):
    """The word-level kernel with the chain inside (is_start, carry in and
    out) against select_words_chained_plain (the chain, then the
    tile-state selection): columns in the same order, carry out equal;
    one call, at most three launches (no more than four), one host read,
    and neither the chain's PyTorch ops nor the plain versions."""
    import warnings

    args = _words_case(case)
    want, want_carry = minima.select_words_chained_plain(*args)
    dev = _to(cuda, args)

    def refuse(*a, **kw):
        raise AssertionError("the chain runs in the kernel")

    for name in ("tile_state_chain_codes", "chain_range",
                 "select_words_tiles_q_plain"):
        monkeypatch.setattr(minima, name, refuse)
    before = (myers_cuda.select_words_chained.launches,
              myers_cuda.select_words_chained.passes)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got, got_carry = minima.select_words_chained(*dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert myers_cuda.select_words_chained.launches == before[0] + 1
    assert myers_cuda.select_words_chained.passes - before[1] <= 3
    syncs = [str(w.message) for w in seen
             if str(w.message).startswith("called a synchronizing")]
    assert len(syncs) == 1, [str(w.message) for w in seen]
    assert want.shape[1] and got.shape == want.shape
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got_carry.cpu(), want_carry.to(torch.int32))


@pytest.mark.parametrize("cut", [1, 4_500, 8_999])
def test_select_words_chained_kernel_carries_across_ranges(cuda, cut):
    """A batched dispatch split into two tile ranges, the carry out of the
    first passed into the second, gives the whole range's candidates and
    carry (the chunks' chain of BatchEngine.dispatch)."""
    args = _words_case((4, 9_000, 5, 5, 0.001, True, False, "carry", 0.6))
    want, want_carry = minima.select_words_chained_plain(*args)
    dev = list(_to(cuda, args))
    T = args[0].shape[-1]

    def part(t0, t1, carry):
        a = [x[..., t0:t1] if isinstance(x, torch.Tensor)
             and x.shape[-1] == T else x for x in dev]
        a[6] = carry
        return minima.select_words_chained(*a)

    first, carry = part(0, cut, dev[6])
    second, carry = part(cut, T, carry)
    second[1] += cut
    got = torch.cat([first, second], 1)
    assert got.shape == want.shape
    np.testing.assert_array_equal(_lexsorted(got), _lexsorted(want))
    assert torch.equal(carry.cpu(), want_carry.to(torch.int32))


def test_q2meta_at_a_capped_width_equals_plain(cuda, monkeypatch):
    """A group whose piece width the dispatch bound caps: a full chunk
    launches at least H100_TARGET_TILES threads, its q2meta launch equals
    the plain version bit for bit, and search_many on the card gives the
    CPU path's Match lists."""
    monkeypatch.setattr(plan, "H100_TARGET_TILES", 64)
    rng = np.random.default_rng(12)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pats = [rng.choice(bases, 23) for _ in range(12)]
    texts = [rng.choice(bases, 60_000), rng.choice(bases, 9_000)]
    for i, t in enumerate(texts):
        t[5000:5023] = pats[i]
        t[5011] = ord("A") if t[5011] != ord("A") else ord("G")
    dna = profiles.Dna()
    codes = [dna.encode(p) for p in pats]
    eng = batch.BatchEngine(cuda)
    ts = batch.TextSet(texts, cuda)
    (wide,) = eng.groups(dna, codes, ts, 3)
    monkeypatch.setattr(batch, "DISPATCH_BYTES", 16 * 64 * 40)
    (g,) = eng.groups(dna, codes, ts, 3)
    assert g.w_chars < wide.w_chars
    pp = ts.piece_plan(g.halo, g.w_chars)
    q0, q1, t0, t1 = next(eng.chunks(g, pp))
    assert (q1 - q0) * (t1 - t0) >= plan.H100_TARGET_TILES
    win = ts.descriptor(dna, pp, False, t0, t1)
    args = (win, pp.true_start[t0:t1], pp.valid_from[t0:t1],
            pp.valid_to[t0:t1], g.pmasks[q0:q1], g.is_pad[q0:q1],
            g.h_init[q0:q1], g.m_real[q0:q1], g.boundary_m[q0:q1], 3,
            g.eq_mode)
    before = myers_cuda.scan_q_meta.launches
    got = myers_cuda.scan_q_meta(*args)
    torch.cuda.synchronize()
    assert myers_cuda.scan_q_meta.launches == before + 1
    want = myers_cuda.scan_q_meta_plain(*_to("cpu", args))
    for name, a, b in zip(("vp", "vm", "cost", "meta", "final"), got, want):
        assert torch.equal(a.cpu(), b), name
    found = Searcher("dna", rc=True, device="cuda").search_many(pats, texts,
                                                                 3)
    assert found
    _same(found, Searcher("dna", rc=True, device="cpu").search_many(
        pats, texts, 3))


# -- the scan kernels' window read (csrc/window_read.cuh) ----------------------


def _random_descriptor(P, L, T, NW, seed, base=0):
    """Random (P, L) planes (on the host) and T tiles at every start
    alignment: windows before the planes, across their start and end and
    past them, wend before, inside and past the window and past L; plane
    words counted from ``base`` (the descriptor's wstart/wend include it,
    the planes hold words base .. base + L - 1 and are read as plane words
    0 .. L - 1 shifted: ``base`` > 0 is for planes past 2^26 words, made
    whole on the card by the caller)."""
    g = np.random.default_rng(seed)
    ws = g.integers(-NW - 3, L + 3, T)
    ws[:8] = np.arange(8) - 4
    ws[8:16] = L - NW + np.arange(8) - 4
    we = ws + g.integers(-2, NW + 6, T)
    we[::5] = L + 7
    planes = g.integers(-2**31, 2**31, (P, L), dtype=np.int64).astype(np.int32)
    return Windows(torch.from_numpy(planes), torch.from_numpy(ws + base),
                   torch.from_numpy(we + base), NW)


def _four_kernels(win, eq_mode, M, seed):
    """(name, kernel, plain, args) of q1meta, q1, q2meta and q2 over the
    windows ``win`` describes, random pattern and tile inputs."""
    NW, P, T = win.shape
    a = _random_inputs(eq_mode, M, T, NW, seed)
    q = _random_q_inputs(eq_mode, 3, M, T, NW, seed + 1)
    return (
        ("q1meta", myers_cuda.scan_meta, myers_cuda.scan_meta_plain,
         (win, *a[1:])),
        ("q1", myers_cuda.scan, myers_cuda.scan_plain,
         (win, a[1], *a[4:9], eq_mode)),
        ("q2meta", myers_cuda.scan_q_meta, myers_cuda.scan_q_meta_plain,
         (win, *q[1:])),
        ("q2", myers_cuda.scan_q, myers_cuda.scan_q_plain,
         (win, q[1], *q[4:9], eq_mode)),
    )


def _held_kernels(cuda, win, eq_mode, M, seed):
    for name, kernel, plain, args in _four_kernels(win, eq_mode, M, seed):
        got = kernel(*_to(cuda, args))
        torch.cuda.synchronize()
        want = plain(*_to("cpu", args))
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), name


@pytest.mark.parametrize("eq_mode", ["iupac", "pure", "ascii"])
@pytest.mark.parametrize("M", [24, 72])
@pytest.mark.parametrize("NW", [1, 6, 41])
def test_scan_kernels_on_descriptors_equal_plain(cuda, eq_mode, M, NW):
    """q1meta, q1, q2meta and q2 reading the planes through descriptors at
    odd wstart, before and past the planes, wend inside a vector: bit for
    bit their plain versions (``windows_plain``, then the scan)."""
    P = 9 if eq_mode == "ascii" else 4
    win = _random_descriptor(P, 256, 700, NW, M + NW)
    _held_kernels(cuda, win, eq_mode, M, NW)


def test_scan_kernels_past_2_31_positions(cuda):
    """Windows of plane words past 2^26 (positions past 2^31): the
    kernels' 64-bit plane offsets against the plain read."""
    L = (1 << 26) + 4096
    near = _random_descriptor(4, 4096, 300, 41, 7, base=L - 4096)
    planes = torch.zeros((4, L), dtype=torch.int32, device=cuda)
    planes[:, L - 4096 :] = near.planes.to(cuda)
    win = Windows(planes, near.wstart.to(cuda), near.wend.to(cuda), 41)
    assert int(win.wstart.max()) * 32 > 1 << 31
    for name, kernel, plain, args in _four_kernels(win, "iupac", 24, 8):
        args = _to(cuda, args)
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        for a, b in zip(got, want):
            assert torch.equal(a, b), name


def test_scan_kernels_halo_wider_than_tiles(cuda, monkeypatch):
    """The single engine's descriptors with halo > W (a plan of 3-word
    tiles): q1meta and q1 against their plain versions on the card, and
    the candidates against the CPU path's."""
    monkeypatch.setattr(myers_torch, "plan_tiles",
                        lambda words, halo: (-(-words // 3), 3, halo))
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    text = rng.choice(bases, 20_000)
    pat = rng.choice(bases, 120)
    text[7000:7120] = pat
    prof = profiles.Iupac()
    for alpha in (None, 0.1):
        got = {}
        for dev in ("cuda", "cpu"):
            eng = myers_torch.TorchEngine(dev)
            inp = eng.build_inputs(prof, prof.encode(pat), text, 10, alpha)
            assert inp.halo > inp.W
            if dev == "cuda":
                outs = eng.scan(inp)
                torch.cuda.synchronize()
                plain = (myers_cuda.scan_meta_plain if inp.fast
                         else myers_cuda.scan_plain)
                args = ((inp.windows, inp.tile0, inp.valid_from,
                         inp.valid_to) if inp.fast
                        else (inp.windows, inp.tile0))
                rest = ((inp.pmasks, inp.is_pad, inp.h_init, inp.m_real,
                         inp.boundary_m) + ((inp.k,) if inp.fast else ())
                        + (inp.eq_mode,))
                for a, b in zip(outs, plain(*args, *rest)):
                    assert torch.equal(a, b)
            got[dev] = eng.candidates(prof, prof.encode(pat), text, 10,
                                      alpha, None, False)
        assert got["cuda"] == got["cpu"] and got["cuda"]


@pytest.mark.parametrize("steps", [0, 101])
def test_scan_kernels_on_piece_descriptors(cuda, steps):
    """q2meta and q2 over a text set's pieces (texts that end inside a
    window, an empty and a one-char text) read from the planes against
    their plain versions."""
    rng = np.random.default_rng(steps)
    bases = np.frombuffer(b"ACGT", np.uint8)
    texts = [rng.choice(bases, int(n)) for n in rng.integers(0, 3000, 40)]
    texts[3], texts[4] = texts[3][:0], texts[4][:1]
    ts = batch.TextSet(texts, cuda)
    pp = ts.piece_plan(27, 512, steps)
    win = ts.descriptor(profiles.Iupac(), pp, True, 0, pp.T)
    assert bool((win.wend - win.wstart < win.NW).any())
    _held_kernels(cuda, win, "iupac", 24, steps)


def test_prefilters_on_descriptors(cuda, monkeypatch):
    """Both suffix prefilters read the planes through descriptors: the
    tiles and pieces they flag on the card equal the CPU path's, and the
    sharded search with the prefilter forced on equals the single
    engine."""
    from sassy_tpu_torch.parallel import ShardedSearch, make_mesh

    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", 0)
    monkeypatch.setattr(plan, "H100_TARGET_TILES", 64)
    rng = np.random.default_rng(9)
    bases = np.frombuffer(b"ACGT", np.uint8)
    text = rng.choice(bases, 200_001)
    pat = rng.choice(bases, 80)
    for at in (1000, 99_990, 150_000):
        text[at : at + 80] = pat
        text[at + 40] = ord("A") if text[at + 40] != ord("A") else ord("C")
    prof = profiles.Iupac()
    flagged = {}
    for dev in ("cuda", "cpu"):
        eng = myers_torch.TorchEngine(dev)
        inp = eng.build_inputs(prof, prof.encode(pat), text, 3)
        assert inp.hier_s
        flagged[dev] = eng.flagged_tiles(inp).cpu()
    assert flagged["cuda"].numel() and torch.equal(*flagged.values())
    reads = [text[i : i + 5000] for i in range(0, 200_000, 5000)]
    codes = [prof.encode(pat)]
    for dev in ("cuda", "cpu"):
        beng = batch.BatchEngine(dev)
        ts = batch.TextSet(reads, dev)
        (g,) = beng.groups(prof, codes, ts, 3)
        pp = ts.piece_plan(g.halo, g.w_chars)
        win = ts.descriptor(prof, pp, False, 0, pp.T)
        flagged[dev] = beng.flagged_pieces(win, g, pp, 0, 1, 0, pp.T, 3).cpu()
    assert flagged["cuda"].numel() and torch.equal(*flagged.values())
    got = ShardedSearch(mesh=make_mesh(4, 1), hier=True).candidates_batch(
        prof, [pat], text, 3)
    want = myers_torch.TorchEngine("cuda").candidates(
        prof, prof.encode(pat), text, 3, None, None, False)
    assert got == [want] and want


def test_scan_kernels_refuse_bad_descriptors(cuda):
    args = list(_random_inputs("iupac", 24, 16, 5, 3))
    good = _desc_to(cuda, _random_descriptor(4, 64, 16, 5, 3))
    bad = {
        "rows": Windows(good.planes[:, :62].contiguous(), good.wstart,
                        good.wend, 5),
        "unaligned": Windows(good.planes.view(-1)[1:1 + 4 * 60].view(4, 60),
                             good.wstart, good.wend, 5),
        "dtype": Windows(good.planes, good.wstart.int(), good.wend, 5),
        "tiles": Windows(good.planes, good.wstart[:15], good.wend[:15], 5),
        "2-d tables": Windows(good.planes, good.wstart[None], good.wend, 5),
    }
    dev_args = _to(cuda, args[1:])
    myers_cuda.scan_meta(good, *dev_args)
    for name, win in bad.items():
        with pytest.raises(ValueError):
            myers_cuda.scan_meta(win, *dev_args)
            pytest.fail(name)


# -- the text pack kernel ----------------------------------------------------

#: the four pack descriptors: DNA and IUPAC (table5), ascii with and
#: without case folding (byte, with the validity plane)
PACK_PROFILES = {"dna": profiles.Dna(), "iupac": profiles.Iupac(),
                 "ascii_fold": profiles.Ascii(case_sensitive=False),
                 "ascii": profiles.Ascii(case_sensitive=True)}


def _pack_kw(prof) -> dict:
    return dict(planes=prof.planes, with_valid=prof.eq_mode == "ascii",
                mode=prof.pack_mode, shift=prof.pack_shift,
                mask=prof.pack_mask, pmasks=tuple(prof.pack_plane_masks),
                fold=prof.pack_fold_case)


@pytest.mark.parametrize("name", list(PACK_PROFILES))
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000, 4133, 1_000_003])
def test_pack_kernel_equals_plain(cuda, name, n):
    """Random bytes of all 256 values: the kernel given the n bytes alone
    (the engines' upload), a whole buffer with garbage past n, and a view
    one byte into a buffer (not 16-byte aligned), against ``pack_plain``
    on the buffer, bit for bit; one launch each."""
    from sassy_tpu_torch.ops import myers_torch

    kw = _pack_kw(PACK_PROFILES[name])
    gw = plan._bucket_words(plan.cdiv(n, 32) + plan.TAIL_RESERVE_WORDS)
    buf = torch.from_numpy(np.random.default_rng(n).integers(
        0, 256, gw * 32 + 1, dtype=np.uint8))
    want = myers_torch.pack_plain(buf[: gw * 32], n // 32, n % 32, **kw)
    dev = buf.to(cuda)
    shifted = torch.empty(n + 1, dtype=torch.uint8, device=cuda)
    shifted[1:] = dev[:n]  # the n bytes one past an aligned address
    before = myers_cuda.pack.launches
    for text in (dev[:n].clone(), dev[: gw * 32], shifted[1:]):
        got = myers_cuda.pack(text, n // 32, n % 32, gw=gw, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    assert myers_cuda.pack.launches == before + 3


@pytest.mark.parametrize("name", list(PACK_PROFILES))
def test_pack_kernel_every_nb(cuda, name):
    """n = 32 * 9 + nb for every nb over two shuffled copies of 0..255,
    garbage past n."""
    from sassy_tpu_torch.ops import myers_torch

    kw = _pack_kw(PACK_PROFILES[name])
    rng = np.random.default_rng(9)
    buf = torch.from_numpy(np.concatenate(
        [rng.permutation(256), rng.permutation(256)]).astype(np.uint8))
    dev = buf.to(cuda)
    for nb in range(32):
        n = 32 * 9 + nb
        want = myers_torch.pack_plain(buf, 9, nb, **kw)
        assert torch.equal(myers_cuda.pack(dev[:n], 9, nb, gw=16,
                                           **kw).cpu(), want), nb


def test_pack_engines_launch_the_kernel(cuda):
    """The single engine's ``prepare`` (DNA and ascii), the batched
    ``TextSet.planes`` (both strands) and the sharded ``planes_sharded``
    pack through the kernel on the card, never ``pack_plain``, and equal
    their CPU paths' planes."""
    from sassy_tpu_torch.ops import myers_torch
    from sassy_tpu_torch.parallel import ShardedText

    rng = np.random.default_rng(3)
    text = rng.choice(np.frombuffer(b"ACGTacgtNRY", np.uint8), 70_001)
    texts = [rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
             for n in (1000, 33, 4133, 0, 64)]
    plain = myers_torch.pack_plain.calls
    before = myers_cuda.pack.launches
    for prof in (profiles.Dna(), profiles.Ascii(case_sensitive=False)):
        got = myers_torch.PreparedText(prof, text, cuda)
        want = myers_torch.PreparedText(prof, text, "cpu")
        assert torch.equal(got.planes.cpu(), want.planes)
    assert myers_cuda.pack.launches == before + 2
    dna = profiles.Dna()
    plain_set = batch.pack_set_plain.calls
    before_set = myers_cuda.pack_set.launches
    ts, ts_cpu = batch.TextSet(texts, cuda), batch.TextSet(texts, "cpu")
    for reverse in (False, True):
        assert torch.equal(ts.planes(dna, reverse).cpu(),
                           ts_cpu.planes(dna, reverse))
    # the text set's planes: one launch of its own kernel a strand
    assert myers_cuda.pack_set.launches == before_set + 2
    assert myers_cuda.pack.launches == before + 2
    iupac = profiles.Iupac()
    got = ShardedText(iupac, text).planes_sharded(4, 600, 5, [0, 3], cuda)
    want = ShardedText(iupac, text).planes_sharded(4, 600, 5, [0, 3], "cpu")
    for d in (0, 3):
        assert torch.equal(got[d].cpu(), want[d])
    assert myers_cuda.pack.launches == before + 4
    # the CPU paths above ran the plain versions (the set's plain pack
    # through pack_plain); the card's never did
    assert batch.pack_set_plain.calls == plain_set + 2
    assert myers_torch.pack_plain.calls == plain + 2 + 2 + 2


@pytest.mark.parametrize("bad", ["dtype", "strided", "short", "words",
                                 "nb", "2d", "planes", "shift"])
def test_pack_kernel_refuses_bad_inputs(cuda, bad):
    """ValueError before any launch: another dtype, a strided text, n
    past the text or past gw words, nb outside 0..31, a 2-D text, more
    than 8 planes, a table5 shift past 7."""
    kw = _pack_kw(profiles.Dna())
    text = torch.zeros(256, dtype=torch.uint8, device=cuda)
    args = {"dtype": (text.to(torch.int32), 2, 0, {}),
            "strided": (text[::2], 2, 0, {}),
            "short": (text[:40], 2, 0, {}),
            "words": (text, 9, 0, {"gw": 8}),
            "nb": (text, 2, 32, {}),
            "2d": (text.view(8, 32), 2, 0, {}),
            "planes": (text, 2, 0, {"planes": 9}),
            "shift": (text, 2, 0, {"shift": 9})}[bad]
    before = myers_cuda.pack.launches
    with pytest.raises(ValueError):
        myers_cuda.pack(args[0], args[1], args[2], **{**kw, **args[3]})
    assert myers_cuda.pack.launches == before


# -- the text set's pack kernel ----------------------------------------------

#: (profile, overhang steps): steps only on IUPAC, the profile with overhang
PACK_SET_CASES = [("dna", 0), ("iupac", 0), ("iupac", 7), ("iupac", 101),
                  ("ascii_fold", 0), ("ascii", 0)]


def _pack_set_texts(seed: int) -> list:
    """Texts of 0, 1, 31, 32 and 33 bytes and random lengths, of all 256
    byte values."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, 31, 32, 33, 0, 64, 95, 1000, 70_001]
    lens += rng.integers(0, 5000, 40).tolist()
    return [rng.integers(0, 256, n, dtype=np.uint8) for n in lens]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name,steps", PACK_SET_CASES)
def test_pack_set_kernel_equals_plain(cuda, name, steps, reverse):
    """The text set's pack kernel against ``pack_set_plain`` on the same
    bytes and tables, bit for bit: the set as ``TextSet`` uploads it, the
    same bytes one byte past an aligned address, and the texts scattered in
    a shuffled order with random bytes between them; one launch each."""
    prof = PACK_PROFILES[name]
    texts = _pack_set_texts(steps + reverse)
    ts = batch.TextSet(texts, cuda)
    data, (starts, lens, wofs) = ts.data(), ts.tables(steps)
    width = myers_torch.aligned_words(ts.words(steps) + 1)
    shifted = torch.empty(data.numel() + 1, dtype=torch.uint8, device=cuda)
    shifted[1:] = data
    rng = np.random.default_rng(7)
    order = rng.permutation(len(texts))
    gaps = rng.integers(0, 40, len(texts))
    scattered = rng.integers(0, 256, data.numel() + int(gaps.sum()),
                             dtype=np.uint8)
    at, s_starts = 0, np.zeros(len(texts), np.int64)
    for t, gap in zip(order, gaps):
        at += int(gap)
        s_starts[t] = at
        scattered[at : at + len(texts[t])] = texts[t]
        at += len(texts[t])
    layouts = [(data, starts), (shifted[1:], starts),
               (torch.from_numpy(scattered).to(cuda),
                torch.from_numpy(s_starts).to(cuda))]
    before = myers_cuda.pack_set.launches
    for d, st in layouts:
        got = myers_cuda.pack_set(d, st, lens, wofs, width, prof, reverse,
                                  steps)
        torch.cuda.synchronize()
        want = batch.pack_set_plain(d.cpu(), st.cpu(), lens.cpu(),
                                    wofs.cpu(), width, prof, reverse, steps)
        assert torch.equal(got.cpu(), want)
    assert myers_cuda.pack_set.launches == before + 3


def test_pack_set_textset_one_launch_a_strand(cuda):
    """``TextSet.planes`` on the card: one launch of the text set's kernel
    per (strand, steps), cached after, no plain set pack and no one-text
    pack, equal to the CPU text set's planes."""
    texts = _pack_set_texts(11)
    iupac = profiles.Iupac()
    ts, ts_cpu = batch.TextSet(texts, cuda), batch.TextSet(texts, "cpu")
    before, plain = myers_cuda.pack_set.launches, batch.pack_set_plain.calls
    packs = myers_cuda.pack.launches
    for _ in range(2):
        for reverse in (False, True):
            for steps in (0, 7):
                ts.planes(iupac, reverse, steps)
    assert myers_cuda.pack_set.launches == before + 4
    assert batch.pack_set_plain.calls == plain
    assert myers_cuda.pack.launches == packs
    for reverse in (False, True):
        for steps in (0, 7):
            assert torch.equal(ts.planes(iupac, reverse, steps).cpu(),
                               ts_cpu.planes(iupac, reverse, steps))


@pytest.mark.parametrize("bad", ["no overhang", "table device", "int32",
                                 "strided", "wofs"])
def test_pack_set_kernel_refuses_bad_inputs(cuda, bad):
    """ValueError before any launch: overhang steps on DNA, tables on the
    CPU, int32 bytes, a strided buffer, a wofs of T entries."""
    ts = batch.TextSet(_pack_set_texts(3), cuda)
    data, (starts, lens, wofs) = ts.data(), ts.tables(0)
    args = dict(data=data, starts=starts, lens=lens, wofs=wofs,
                width=ts.words() + 4, profile=profiles.Iupac(), steps=0)
    args.update({"no overhang": dict(profile=profiles.Dna(), steps=7),
                 "table device": dict(lens=lens.cpu()),
                 "int32": dict(data=data.to(torch.int32)),
                 "strided": dict(data=data[::2]),
                 "wofs": dict(wofs=wofs[1:])}[bad])
    before = myers_cuda.pack_set.launches
    with pytest.raises(ValueError):
        myers_cuda.pack_set(**args)
    assert myers_cuda.pack_set.launches == before


def _tiny_pack_set_texts(seed: int, n_texts: int) -> list:
    """Many texts of 1-3 words (1-96 bytes) with runs of empty ones (one
    of 40, more than a warp's lanes) and one text of 300 words among
    them, of all 256 byte values."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 97, n_texts).tolist()
    lens[100:100] = [0] * 40
    lens[n_texts // 2:n_texts // 2] = [300 * 32 - 5, 0, 0, 1, 0]
    return [rng.integers(0, 256, n, dtype=np.uint8) for n in lens]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name,steps", [("dna", 0), ("iupac", 7),
                                        ("iupac", 101)])
def test_pack_set_kernel_many_tiny_texts(cuda, name, steps, reverse):
    """The text set's pack kernel on 50,000 texts of 1-3 words (each
    warp's words span many texts; a run of 40 empty texts takes a second
    staging round) and on one text of 2 MB (every warp's range inside it),
    both against ``pack_set_plain``, bit for bit, aligned and one byte
    past."""
    prof = PACK_PROFILES[name]
    for texts in (_tiny_pack_set_texts(steps + reverse, 50_000),
                  [np.random.default_rng(5).integers(
                      0, 256, (2 << 20) + 13, dtype=np.uint8)]):
        ts = batch.TextSet(texts, cuda)
        data, (starts, lens, wofs) = ts.data(), ts.tables(steps)
        width = myers_torch.aligned_words(ts.words(steps) + 1)
        shifted = torch.empty(data.numel() + 1, dtype=torch.uint8,
                              device=cuda)
        shifted[1:] = data
        for d in (data, shifted[1:]):
            got = myers_cuda.pack_set(d, starts, lens, wofs, width, prof,
                                      reverse, steps)
            want = batch.pack_set_plain(d.cpu(), starts.cpu(), lens.cpu(),
                                        wofs.cpu(), width, prof, reverse,
                                        steps)
            assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", ["dna", "iupac", "ascii_fold"])
def test_single_engine_strands_from_one_upload(cuda, name):
    """``prepare_strands`` on the card: one pack launch and one set pack
    launch; the reverse strand's planes equal the pack of the flipped
    bytes, the forward strand's the pack of the bytes, and the CPU pair's
    planes."""
    prof = PACK_PROFILES[name]
    text = np.random.default_rng(4).integers(0, 256, 1_000_003,
                                             dtype=np.uint8)
    eng = myers_torch.TorchEngine(cuda)
    packs, sets = myers_cuda.pack.launches, myers_cuda.pack_set.launches
    fwd, rev = eng.prepare_strands(prof, text)
    assert (myers_cuda.pack.launches - packs,
            myers_cuda.pack_set.launches - sets) == (1, 1)
    flipped = torch.from_numpy(text).to(cuda).flip(0)
    kw = _pack_kw(prof)
    want = myers_cuda.pack(flipped, len(text) // 32, len(text) % 32,
                           gw=rev.gw, **kw)
    assert torch.equal(rev.planes, want)
    assert torch.equal(fwd.planes, myers_cuda.pack(
        torch.from_numpy(text).to(cuda), len(text) // 32, len(text) % 32,
        gw=fwd.gw, **kw))
    cpu = myers_torch.TorchEngine("cpu").prepare_strands(prof, text)
    assert torch.equal(fwd.planes.cpu(), cpu[0].planes)
    assert torch.equal(rev.planes.cpu(), cpu[1].planes)


def test_two_strand_search_on_the_card_prepares_once(cuda):
    """A two-strand ``Searcher.search`` of a read-only array on the card:
    the first search launches the pack and the set pack once each, the
    second neither, and both equal the CPU path's Match list."""
    rng = np.random.default_rng(12)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), 200_000)
    pat = text[150_000:150_023].copy()
    rc = np.frombuffer(profiles.Dna().reverse_complement(pat), np.uint8)
    text[50_000:50_023] = rc
    text = np.frombuffer(text.tobytes(), np.uint8)
    s = Searcher("dna", rc=True, device=cuda)
    want = Searcher("dna", rc=True, device="cpu").search(pat, text, 2)
    for launched in ((1, 1), (0, 0)):
        packs, sets = myers_cuda.pack.launches, myers_cuda.pack_set.launches
        got = s.search(pat, text, 2)
        assert (myers_cuda.pack.launches - packs,
                myers_cuda.pack_set.launches - sets) == launched
        assert [(m.sort_key(), m.cigar.to_string()) for m in got] == [
            (m.sort_key(), m.cigar.to_string()) for m in want]
    assert {m.strand.name for m in want} == {"FWD", "RC"}


TRACE_PROFILES = {"iupac": (profiles.Iupac, b"ACGTACGTRYN"),
                  "dna": (profiles.Dna, b"ACGTacgtN"),
                  "ascii": (profiles.Ascii, b"abcABC .!9"),
                  "ascii_fold": (lambda: profiles.Ascii(case_sensitive=False),
                                 b"abcABC .!9")}


def _trace_inputs(dev, pname, reverse, alpha, mo, m, k, seed=0):
    """The traceback kernel's inputs over a text set on ``dev``: planted
    copies with an edit or two, random ends from 0 to past each text's end
    (its overshoot with alpha), copies hanging off a text's start; the
    strand's planes as the batched search packs them."""
    make, alphabet = TRACE_PROFILES[pname]
    prof = make()
    g = np.random.default_rng(seed + m + 7 * k)
    ab = np.frombuffer(alphabet, np.uint8)
    pats = np.stack([g.choice(ab, m) for _ in range(4)])
    steps = semantics.overhang_steps(m, k, alpha, mo)
    texts, pids, tids, ends = [], [], [], []
    for t, n in enumerate((1, m // 2 + 1, 257, 700, 5000)):
        seq = g.choice(ab, n)
        for _ in range(n // 250):
            at = int(g.integers(0, n - m))
            q = int(g.integers(0, 4))
            seq[at : at + m] = pats[q]
            seq[at + int(g.integers(0, m))] = g.choice(ab)
            pids.append(q)
            ends.append(at + m)
        if steps and n > m:
            seq[: m - min(steps, m - 1)] = pats[0][min(steps, m - 1):]
            pids.append(0)
            ends.append(m - min(steps, m - 1))
        extra = [0, 1, n, n + steps] + g.integers(0, n + steps + 1,
                                                  20).tolist()
        pids += g.integers(0, 4, len(extra)).tolist()
        ends += extra
        tids += [t] * (len(ends) - len(tids))
        texts.append(seq[::-1].copy() if reverse else seq)
    ts = batch.TextSet(texts, dev)
    if steps:
        ts.planes(prof, reverse, steps)
    planes, word0 = ts.strand_planes(prof, reverse)
    tids, ends = np.array(tids), np.array(ends, np.int64)
    fill = m + k
    off = np.maximum(0, ends - fill)
    wlen = np.minimum(ends, np.array([len(x) for x in texts])[tids]) - off
    cand = np.stack([np.array(pids, np.int64), word0[tids], off, wlen, ends])
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (planes, to(np.stack([prof.encode(p) for p in pats])), to(cand),
            to(traceback.trace_tables(m, alpha, mo)), prof, fill,
            alpha is not None)


@pytest.mark.parametrize("m,k", [(8, 0), (8, 2), (24, 0), (24, 6),
                                 (120, 10), (120, 30)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("pname,overhang", [
    (p, None) for p in TRACE_PROFILES] + [("iupac", (0.5, None)),
                                          ("iupac", (0.5, 3))])
def test_trace_kernel_equals_plain(cuda, pname, overhang, reverse, m, k):
    """One launch, its output rows bit for bit the plain version's on the
    same planes and inputs; chunked, the same rows."""
    alpha, mo = overhang or (None, None)
    args = _trace_inputs(cuda, pname, reverse, alpha, mo, m, k)
    before = myers_cuda.trace_windows.launches
    got = myers_cuda.trace_windows(*args, 1 << 20)
    torch.cuda.synchronize()
    assert myers_cuda.trace_windows.launches == before + 1
    want = traceback.trace_plain(*args)
    assert torch.equal(got.cpu(), want)
    chunked = myers_cuda.trace_windows(*args, 7)
    assert torch.equal(chunked.cpu(), want)
    failed = traceback.unpack_trace(want.numpy(), args[1].shape[1],
                                    args[5])[5]
    assert not failed.any()


def _edge_trace_inputs(dev, pname, reverse, m, k, seed=0):
    """The traceback kernel's inputs at the Myers words' edges on ``dev``:
    over three texts, windows of 31, 32 and 33 positions starting at every
    offset modulo 32 (some ending past their window: end overshoot), and
    full windows of m + k positions ending at planted copies with an edit;
    iupac with alpha 0.5, the others without overhang."""
    make, alphabet = TRACE_PROFILES[pname]
    prof = make()
    alpha = 0.5 if pname == "iupac" else None
    g = np.random.default_rng(seed + m)
    ab = np.frombuffer(alphabet, np.uint8)
    pats = np.stack([g.choice(ab, m) for _ in range(2)])
    fill = m + k
    texts, cols = [], []
    for t, n in enumerate((1100 + 7 * m, 1333 + 5 * m, 1500 + 9 * m)):
        seq = g.choice(ab, n)
        for r in range(32):
            for i0 in (31, 32, 33):
                over = int(g.integers(0, 3)) if i0 == 32 else 0
                off = 33 * r + t
                cols.append((int(g.integers(0, 2)), t, off, i0,
                             off + i0 + over))
        for e in range(fill + 40, n - 1, max(fill + 40, n // 6)):
            q = int(g.integers(0, 2))
            seq[e - m : e] = pats[q]
            seq[e - int(g.integers(1, m))] = g.choice(ab)
            cols.append((q, t, e - fill, fill, e))
        texts.append(seq[::-1].copy() if reverse else seq)
    ts = batch.TextSet(texts, dev)
    steps = semantics.overhang_steps(m, k, alpha, None)
    if steps:
        ts.planes(prof, reverse, steps)
    planes, word0 = ts.strand_planes(prof, reverse)
    cand = np.array(cols, np.int64).T.copy()
    cand[1] = word0[cand[1]]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (planes, to(np.stack([prof.encode(p) for p in pats])), to(cand),
            to(traceback.trace_tables(m, alpha, None)), prof, fill,
            alpha is not None)


@pytest.mark.parametrize("m", [31, 32, 33, 64, 65, 200])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("pname", ["iupac", "ascii"])
def test_trace_kernel_at_word_edges(cuda, pname, reverse, m):
    """At the Myers words' edges the kernel's rows are the plain
    version's bit for bit, in one launch and chunked."""
    args = _edge_trace_inputs(cuda, pname, reverse, m, m // 2)
    want = traceback.trace_plain(*args)
    for chunk in (1 << 20, 13):
        got = myers_cuda.trace_windows(*args, chunk)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    assert not traceback.unpack_trace(want.numpy(), m, args[5])[5].any()


def test_trace_kernel_long_pattern(cuda, monkeypatch):
    """A 500 bp pattern at k = 50 (18 window words a row: three groups of
    the fill): the kernel's rows equal the plain version's; through
    ``trace_cells_batch`` with a small ``FILL_BYTES`` (a launch a
    candidate) the Traced equals the CPU path's."""
    m, k = 500, 50
    args = _edge_trace_inputs(cuda, "iupac", False, m, k)
    cand = args[2]
    keep = torch.arange(0, cand.shape[1], 9, device=cuda)  # a few windows
    args = (args[0], args[1], cand[:, keep].contiguous(), *args[3:])
    want = traceback.trace_plain(*args)
    assert torch.equal(myers_cuda.trace_windows(*args, 1 << 20).cpu(), want)
    rng = np.random.default_rng(5)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), 4000)
    pat = text[1500:2000].copy()
    pat[[10, 250, 400]] = [ord("A") if c != ord("A") else ord("C")
                           for c in pat[[10, 250, 400]]]
    ends = np.array([2000, 1999, 2003, 2040, 3000], np.int64)
    prof = profiles.Iupac()
    traced = []
    monkeypatch.setattr(traceback, "FILL_BYTES", 3 << 20)
    for dev in ("cpu", cuda):
        planes = batch.TextSet([text], dev).strand_planes(prof, False)
        before = myers_cuda.trace_windows.launches
        tr = traceback.trace_cells_batch(
            prof, [pat], [prof.encode(pat)], [text], np.array([4000]),
            np.zeros(5, np.int64), np.zeros(5, np.int64), ends, m + k, None,
            None, traceback.StrandPlanes(*planes))
        traced.append([x.tolist() for x in tr[:5]]
                      + [[c.to_string() for c in tr.cigars]])
    # 3 MiB of FILL_BYTES hold two candidates' cost matrices: three launches
    assert myers_cuda.trace_windows.launches - before == 3
    assert traced[0] == traced[1] and traced[0][0][0] == 3


def _trace_searches(dev):
    """Both engines' Match lists (CIGARs included) of an iupac search with
    overhang, and of a dna and an ascii one, on ``dev``."""
    rng = np.random.default_rng(19)
    reads = [rng.choice(np.frombuffer(b"ACGT", np.uint8), 3000)
             for _ in range(40)]
    pats = [r[1000:1024].copy() for r in reads[:4]]
    reads[5][:20] = pats[1][4:]
    reads[6][-20:] = pats[2][:20]
    out = []
    for prof, kw, k in (("iupac", {"rc": True, "alpha": 0.5}, 3),
                        ("dna", {"rc": True}, 2), ("ascii", {}, 2)):
        s = Searcher(prof, device=dev, **kw)
        out.append(s.search_many(pats, reads, k))
        out.append(s.search(pats[0], reads[0], k))
    return [[(m.sort_key(), m.cigar.to_string()) for m in ms] for ms in out]


@pytest.mark.parametrize("fill_bytes", [None, 3000])
def test_searcher_traces_on_the_card(cuda, fill_bytes, monkeypatch):
    """Both engines' finish on the card traces with the kernel (one launch
    a pattern length and strand, or a chunk of a small ``FILL_BYTES``) and
    never its plain version, and equals the CPU path's matches."""
    if fill_bytes:
        monkeypatch.setattr(traceback, "FILL_BYTES", fill_bytes)
    want = _trace_searches("cpu")
    plain = traceback.trace_plain.calls
    before = myers_cuda.trace_windows.launches
    got = _trace_searches(cuda)
    assert traceback.trace_plain.calls == plain
    launched = myers_cuda.trace_windows.launches - before
    assert got == want and all(got)
    # a chunk of one candidate under the small cap: a launch a candidate
    assert launched >= (sum(map(len, got)) if fill_bytes else 4)


def test_forced_trace_failure_raises_as_on_the_cpu(cuda, monkeypatch):
    """Start-overshoot costs that disagree with the fill's left column
    fail the walks that stop at column 0, on the card as on the CPU: both
    walk one again on the host and raise the same TraceError."""
    trace_tables = traceback.trace_tables

    def off_by_one(m, alpha, max_overhang):
        t = trace_tables(m, alpha, max_overhang)
        t[1, 1:] += 1
        return t

    monkeypatch.setattr(traceback, "trace_tables", off_by_one)
    pat = b"ACGTTGCAAGGCTTACGATCGATC"
    text = pat[4:] + b"T" * 40
    errors = []
    for dev in ("cpu", cuda):
        with pytest.raises(traceback.TraceError) as err:
            Searcher("iupac", alpha=0.5, device=dev).search_many(
                [pat], [text], 2)
        errors.append(str(err.value))
    assert errors[0] == errors[1] == (
        "vectorized walk failed but scalar walk passed")


def test_trace_kernel_rejects_bad_inputs(cuda):
    args = list(_trace_inputs(cuda, "dna", False, None, None, 8, 2))
    with pytest.raises(ValueError):
        myers_cuda.trace_windows(*[a.cpu() if isinstance(a, torch.Tensor)
                                   else a for a in args], 64)
    for i, bad in ((0, args[0].to(torch.int64)), (1, args[1].to(torch.int32)),
                   (2, args[2][:4].contiguous()), (3, args[3][:, :-1])):
        with pytest.raises(ValueError):
            myers_cuda.trace_windows(*args[:i], bad, *args[i + 1:], 64)
    with pytest.raises(ValueError):
        myers_cuda.trace_windows(*args, 0)
