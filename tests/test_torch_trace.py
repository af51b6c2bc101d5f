"""The host finish's traceback read from the strand's planes: the codes
the traceback decodes from the planes equal ``profile.encode`` over all
256 bytes, for every profile and both strands, on the text set's planes and
the single engine's; the plain version (``traceback.trace_plain``, through
``trace_cells_batch``) equals ``sassy_tpu.traceback.trace_candidates_batch``
Match for Match with CIGAR; and the kernel's per-candidate work
(``csrc/trace.cuh``), built with g++ through ``tests/torch_trace_host.cc``,
equals the plain version's output rows bit for bit (start, total cost,
pattern start and end, failed, every op byte), chunked or not, a forced
failure included.

The cases: iupac, dna, ascii and ascii folded; both strands; no overhang,
alpha 0.5, alpha 0.5 with max_overhang 3 (iupac); patterns of 8, 24 and
120; k 0 and m / 4; candidates at a text's start, at random ends, at
planted copies and past a text's end. At the Myers words' edges: patterns
of 31, 32, 33, 64, 65 and 200 (one word of pattern rows and more), windows
of 31, 32 and 33 positions at every offset modulo 32 and full windows of
several words (more than a fill keeps in registers at 200), over iupac
with overhang and ascii, both strands.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from sassy_tpu import profiles as ref_profiles
from sassy_tpu import traceback as ref_traceback
from sassy_tpu_torch import (Searcher, diagnostics, gxx, profiles, semantics,
                             traceback)
from sassy_tpu_torch.ops import batch, myers_cuda
from sassy_tpu_torch.ops.myers_torch import PreparedText

PROFILES = {
    "iupac": (profiles.Iupac, ref_profiles.Iupac, b"ACGTACGTACGTRYN"),
    "dna": (profiles.Dna, ref_profiles.Dna, b"ACGTACGTacgtN"),
    "ascii": (profiles.Ascii, ref_profiles.Ascii, b"abcdeABCDE .!09"),
    "ascii_fold": (lambda: profiles.Ascii(case_sensitive=False),
                   lambda: ref_profiles.Ascii(case_sensitive=False),
                   b"abcdeABCDE .!09"),
}
#: name -> (alpha, max_overhang)
OVERHANG = {"none": (None, None), "alpha": (0.5, None),
            "max_overhang": (0.5, 3)}
CASES = [(p, s, o, m, kk) for p in PROFILES for s in ("fwd", "rc")
         for o in (OVERHANG if p == "iupac" else ("none",))
         for m in (8, 24, 120) for kk in ("k0", "k_quarter")]


def _case_id(case):
    return "-".join(map(str, case))


def _host():
    """The host program over trace.cuh, built with g++ (as the selection
    walk's) into build/sassy_tpu_torch/."""
    here = os.path.dirname(os.path.abspath(__file__))
    csrc = myers_cuda.CSRC
    lib = ctypes.CDLL(str(gxx.build(
        "trace_host", [os.path.join(here, "torch_trace_host.cc"),
                       csrc / "trace.cuh", csrc / "myers_word.cuh"],
        ["-std=c++17", "-O1", "-shared", "-fPIC", "-ffp-contract=off",
         f"-I{csrc}"])))
    ptr, num, big = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sassy_trace_host.argtypes = ([ptr, big, num, num, ptr, ptr, big, ptr]
                                     + [num] * 3 + [ptr, big, ptr, big])
    lib.sassy_trace_host.restype = num
    lib.sassy_trace_codes_host.argtypes = [ptr, big, num, big, num, ptr]
    return lib


def _inputs(case, seed=0):
    """Texts, patterns and candidates of one case: (profile, reference
    profile, texts (forward bytes), patterns, k, alpha, max_overhang,
    reverse, pids, tids, ends). Each strand sequence holds planted copies
    of the patterns with an edit or two, one of them hanging off its start
    where overhang allows."""
    pname, strand, oh, m, kk = case
    make, make_ref, alphabet = PROFILES[pname]
    prof, ref = make(), make_ref()
    k = 0 if kk == "k0" else m // 4
    alpha, mo = OVERHANG[oh]
    g = np.random.default_rng(seed + 1000 * m + k)
    alpha_b = np.frombuffer(alphabet, np.uint8)
    pats = [g.choice(alpha_b, m) for _ in range(3)]
    steps = semantics.overhang_steps(m, k, alpha, mo)
    strands, pids, tids, ends = [], [], [], []
    for t, n in enumerate((1, m // 2 + 1, 257, 700)):
        seq = g.choice(alpha_b, n)
        q = t % len(pats)
        copy = pats[q].copy()
        for _ in range(t % 3):
            copy[int(g.integers(0, m))] = g.choice(alpha_b)
        if n >= m + 10:
            at = int(g.integers(0, n - m))
            seq[at : at + m] = copy
            ends += [at + m, at + m - 1, at + m + 1]
            pids += [q] * 3
        if steps and n > m:  # a copy hanging off the start
            hang = min(steps, m - 1)
            seq[: m - hang] = pats[(q + 1) % 3][hang:]
            ends.append(m - hang)
            pids.append((q + 1) % 3)
        tids += [t] * (len(ends) - len(tids))
        extra = [0, 1, min(n, m // 2), n, n + steps, max(0, n + steps - 1)]
        extra += g.integers(0, n + steps + 1, 12).tolist()
        ends += extra
        pids += g.integers(0, 3, len(extra)).tolist()
        tids += [t] * len(extra)
        strands.append(seq)
    reverse = strand == "rc"
    texts = [s[::-1].copy() if reverse else s for s in strands]
    return (prof, ref, texts, pats, k, alpha, mo, reverse,
            np.array(pids, np.int64), np.array(tids, np.int64),
            np.array(ends, np.int64))


def _planes(prof, texts, reverse, steps):
    """The strand's planes of the text set on the CPU, packed with
    ``steps`` overshoot positions where the case has them (as the batched
    search packs them; the traceback reads any steps)."""
    ts = batch.TextSet(texts, "cpu")
    if steps:
        ts.planes(prof, reverse, steps)
    return traceback.StrandPlanes(*ts.strand_planes(prof, reverse))


def _kernel_inputs(case):
    """The traceback kernel's inputs of one case, as trace_cells_batch
    makes them: planes, pattern codes, candidate columns, tables, the
    fill length and whether the start overshoot applies."""
    (prof, _, texts, pats, k, alpha, mo, reverse, pids, tids,
     ends) = _inputs(case)
    m = len(pats[0])
    fill = m + k
    sp = _planes(prof, texts, reverse,
                 semantics.overhang_steps(m, k, alpha, mo))
    lens = np.array([len(t) for t in texts], np.int64)
    off = np.maximum(0, ends - fill)
    wlen = np.minimum(ends, lens[tids]) - off
    cand = np.stack([pids, sp.word0[tids], off, wlen, ends])
    pcodes = np.stack([prof.encode(p) for p in pats])
    return (prof, sp.planes, torch.from_numpy(pcodes),
            torch.from_numpy(np.ascontiguousarray(cand)),
            torch.from_numpy(traceback.trace_tables(m, alpha, mo)), fill,
            alpha is not None)


def _host_trace(lib, planes, pcodes, cand, tables, prof, fill, alpha_on,
                chunk):
    """The host build's output rows over all candidates, ``chunk`` at a
    time in one scratch of delta words (16-byte cells, 16-byte aligned, of
    ``myers_cuda.trace_cells``' size, as ``myers_cuda.trace_windows``
    allocates them), which it writes nothing past."""
    pl = planes.numpy()
    pc, cd, tb = pcodes.numpy(), cand.numpy(), tables.numpy()
    m, B = pc.shape[1], cd.shape[1]
    stride = myers_cuda.TRACE_FIELDS + -(-(m + fill + 1) // 4)
    out = np.zeros((B, stride), np.int32)
    words = myers_cuda.TRACE_CELL_BYTES // 4
    n = words * myers_cuda.trace_cells(chunk, m, fill)
    cells = np.full(n + 64 * words, 0xA5A5A5A5, np.uint32)
    lead = (-cells.ctypes.data) % 16 // 4  # words to a 16-byte boundary
    assert lib.sassy_trace_host(
        pl.ctypes.data, pl.shape[1], prof.planes,
        myers_cuda.TRACE_EQ[prof.eq_mode], pc.ctypes.data, cd.ctypes.data, B,
        tb.ctypes.data, m, fill, int(alpha_on), out.ctypes.data, stride,
        cells[lead:].ctypes.data, chunk) == 0
    assert (cells[:lead] == 0xA5A5A5A5).all()
    assert (cells[lead + n :] == 0xA5A5A5A5).all()
    return out


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("pname", list(PROFILES))
def test_plane_codes_equal_encode(pname, reverse):
    """Every byte value, decoded from the planes of a text set (texts of
    several lengths, so that texts start at many words) and of the single
    engine's prepared text, by the plain version and by the kernel's
    decode built on the host, equals ``profile.encode`` of the strand's
    bytes."""
    prof = PROFILES[pname][0]()
    g = np.random.default_rng(3)
    texts = [g.permutation(np.r_[np.arange(256), g.integers(0, 256, n)]
                           ).astype(np.uint8) for n in (0, 31, 77, 300)]
    lib = _host()
    ts = batch.TextSet(texts, "cpu")
    sets = [(ts.strand_planes(prof, reverse), texts)]
    for text in texts[1:3]:
        prep = PreparedText(prof, text, "cpu", reverse=reverse)
        sets.append(((prep.planes, np.zeros(1, np.int64)), [text]))
    for (planes, word0), group in sets:
        pl = planes.numpy()
        for t, text in enumerate(group):
            want = prof.encode(text[::-1] if reverse else text)
            n = len(text)
            base = np.array([32 * word0[t]], np.int64)
            got = traceback.window_codes(planes, prof, base,
                                         np.array([n]), n)[0]
            np.testing.assert_array_equal(got, want)
            out = np.zeros(n, np.uint8)
            lib.sassy_trace_codes_host(pl.ctypes.data, pl.shape[1],
                                       prof.planes, int(base[0]), n,
                                       out.ctypes.data)
            np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_equals_reference_trace(case):
    """``trace_cells_batch`` on the CPU (the plain version on the planes)
    equals ``sassy_tpu.traceback.trace_candidates_batch`` on each
    candidate's (pattern, strand bytes) pair: cost, coordinates and CIGAR."""
    (prof, ref, texts, pats, k, alpha, mo, reverse, pids, tids,
     ends) = _inputs(case)
    m = len(pats[0])
    lens = np.array([len(t) for t in texts], np.int64)
    pcodes = [prof.encode(p) for p in pats]
    sp = _planes(prof, texts, reverse,
                 semantics.overhang_steps(m, k, alpha, mo))
    calls = traceback.trace_plain.calls
    tr = traceback.trace_cells_batch(prof, pats, pcodes, texts, lens, pids,
                                     tids, ends, m + k, alpha, mo, sp,
                                     reverse)
    assert traceback.trace_plain.calls == calls + 1
    got = list(zip(tr.cost.tolist(), tr.text_start.tolist(),
                   tr.text_end.tolist(), tr.pattern_start.tolist(),
                   tr.pattern_end.tolist(),
                   [c.to_string() for c in tr.cigars]))
    want = [None] * len(ends)
    for q in range(len(pats)):
        for t, text in enumerate(texts):
            rows = np.flatnonzero((pids == q) & (tids == t))
            if not len(rows):
                continue
            seq = text[::-1].copy() if reverse else text
            ms = ref_traceback.trace_candidates_batch(
                ref, pats[q], pcodes[q], seq, ends[rows].tolist(), m + k,
                alpha, mo)
            for r, x in zip(rows.tolist(), ms):
                want[r] = (x.cost, x.text_start, x.text_end,
                           x.pattern_start, x.pattern_end,
                           x.cigar.to_string())
    assert got == want
    assert any(c.to_string() != f"{m}=" for c in tr.cigars)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_host_build_equals_plain(case):
    """The kernel's per-candidate work, built on the host, gives the plain
    version's output rows bit for bit."""
    lib = _host()
    args = _kernel_inputs(case)
    prof, planes, pcodes, cand, tables, fill, alpha_on = args
    want = traceback.trace_plain(planes, pcodes, cand, tables, prof, fill,
                                 alpha_on).numpy()
    got = _host_trace(lib, planes, pcodes, cand, tables, prof, fill,
                      alpha_on, cand.shape[1])
    np.testing.assert_array_equal(got, want)
    i, total, ps, pe, ops, failed = traceback.unpack_trace(
        got, pcodes.shape[1], fill)
    assert not failed.any() and (ops >= 0).any()


EDGE_MS = (31, 32, 33, 64, 65, 200)


def _edge_inputs(pname, strand, m, seed=0):
    """The kernel's inputs at the Myers words' edges: over three texts (so
    that their first plane words differ), windows of 31, 32 and 33
    positions starting at every offset modulo 32, some of them with an
    end past them (end overshoot), and windows of the full fill length
    m + m // 2 ending at planted copies with an edit (those of m = 200
    span ten words)."""
    make, _, alphabet = PROFILES[pname]
    prof = make()
    alpha, mo = OVERHANG["alpha" if pname == "iupac" else "none"]
    g = np.random.default_rng(seed + m)
    ab = np.frombuffer(alphabet, np.uint8)
    pats = [g.choice(ab, m) for _ in range(2)]
    fill = m + m // 2
    texts, pids, tids, offs, wlens, ends = [], [], [], [], [], []
    for t, n in enumerate((1100 + 7 * m, 1333 + 5 * m, 1500 + 9 * m)):
        seq = g.choice(ab, n)
        for r in range(32):
            off = 32 * r + r + t
            for i0 in (31, 32, 33):
                over = int(g.integers(0, 3)) if i0 == 32 else 0
                pids.append(int(g.integers(0, 2)))
                offs.append(off)
                wlens.append(i0)
                ends.append(off + i0 + over)
        for e in range(fill + 40, n - 1, max(fill + 40, n // 6)):
            q = int(g.integers(0, 2))
            seq[e - m : e] = pats[q]
            seq[e - int(g.integers(1, m))] = g.choice(ab)
            pids.append(q)
            offs.append(e - fill)
            wlens.append(fill)
            ends.append(e)
        tids += [t] * (len(ends) - len(tids))
        texts.append(seq)
    reverse = strand == "rc"
    if reverse:
        texts = [x[::-1].copy() for x in texts]
    sp = _planes(prof, texts, reverse,
                 semantics.overhang_steps(m, m // 4, alpha, mo))
    cand = np.stack([np.array(pids, np.int64), sp.word0[tids],
                     np.array(offs, np.int64), np.array(wlens, np.int64),
                     np.array(ends, np.int64)])
    return (prof, sp.planes, torch.from_numpy(
        np.stack([prof.encode(p) for p in pats])),
        torch.from_numpy(np.ascontiguousarray(cand)),
        torch.from_numpy(traceback.trace_tables(m, alpha, mo)), fill,
        alpha is not None)


@pytest.mark.parametrize("m", EDGE_MS)
@pytest.mark.parametrize("strand", ["fwd", "rc"])
@pytest.mark.parametrize("pname", ["iupac", "ascii"])
def test_host_build_at_word_edges(pname, strand, m):
    """At the Myers words' edges (pattern rows across a word of rows,
    windows ending at and beside a word's end at every offset, groups of
    words), the host build gives the plain version's rows bit for bit,
    chunked too."""
    lib = _host()
    prof, planes, pcodes, cand, tables, fill, alpha_on = _edge_inputs(
        pname, strand, m)
    want = traceback.trace_plain(planes, pcodes, cand, tables, prof, fill,
                                 alpha_on).numpy()
    for chunk in (cand.shape[1], 13):
        np.testing.assert_array_equal(_host_trace(
            lib, planes, pcodes, cand, tables, prof, fill, alpha_on, chunk),
            want)
    i, total, ps, pe, ops, failed = traceback.unpack_trace(want, m, fill)
    assert not failed.any()
    assert ((ops == 0).sum(axis=1) >= m - 6).any()  # walks along a copy
    assert set(cand.numpy()[2] % 32) == set(range(32))


@pytest.mark.parametrize("chunk", [1, 5, 64])
@pytest.mark.parametrize("case", [("iupac", "rc", "max_overhang", 24,
                                   "k_quarter"),
                                  ("ascii_fold", "fwd", "none", 8, "k0")],
                         ids=_case_id)
def test_chunks_give_the_same_rows(case, chunk):
    """Candidates traced a chunk at a time in one scratch (the kernel's
    launches; the plain version's fills) give the same rows as one
    chunk."""
    lib = _host()
    prof, planes, pcodes, cand, tables, fill, alpha_on = _kernel_inputs(case)
    want = traceback.trace_plain(planes, pcodes, cand, tables, prof, fill,
                                 alpha_on).numpy()
    np.testing.assert_array_equal(traceback.trace_plain(
        planes, pcodes, cand, tables, prof, fill, alpha_on, chunk).numpy(),
        want)
    np.testing.assert_array_equal(_host_trace(
        lib, planes, pcodes, cand, tables, prof, fill, alpha_on, chunk), want)


def _off_by_one(trace_tables):
    def tables(m, alpha, max_overhang):
        t = trace_tables(m, alpha, max_overhang)
        t[1, 1:] += 1  # the start overshoot's costs
        return t
    return tables


def test_forced_failure_fails_the_same_candidates(monkeypatch):
    """Tables whose start overshoot disagrees with the fill's left column
    fail every walk that stops at column 0: the host build flags the same
    candidates as the plain version, and the Searcher's finish walks one
    again on the host and raises the vectorized walk's error."""
    monkeypatch.setattr(traceback, "trace_tables",
                        _off_by_one(traceback.trace_tables))
    lib = _host()
    args = _kernel_inputs(("iupac", "fwd", "alpha", 24, "k_quarter"))
    prof, planes, pcodes, cand, tables, fill, alpha_on = args
    want = traceback.trace_plain(planes, pcodes, cand, tables, prof, fill,
                                 alpha_on).numpy()
    assert traceback.unpack_trace(want, pcodes.shape[1], fill)[5].any()
    np.testing.assert_array_equal(_host_trace(
        lib, planes, pcodes, cand, tables, prof, fill, alpha_on, 16), want)
    pat = b"ACGTTGCAAGGCTTACGATCGATC"
    text = pat[4:] + b"T" * 40
    s = Searcher("iupac", rc=False, alpha=0.5, device="cpu")
    with pytest.raises(traceback.TraceError,
                       match="vectorized walk failed but scalar walk passed"):
        s.search_many([pat], [text], 2)


def test_trace_bound_counts_what_the_walks_read():
    """``diagnostics.trace_bound``'s bytes and operations, against a count
    candidate by candidate: the plane words of each window's decoded
    columns, the walk's cells and steps."""
    prof, planes, pcodes, cand, tables, fill, alpha_on = _kernel_inputs(
        ("iupac", "rc", "alpha", 24, "k_quarter"))
    out = traceback.trace_plain(planes, pcodes, cand, tables, prof, fill,
                                alpha_on).numpy()
    c = cand.numpy()
    m = pcodes.shape[1]
    words = cells = 0
    for pid, word0, off, wlen, end in c.T.tolist():
        over = max(end - off - wlen, 0)
        i0 = end - off - over
        bits = {(32 * word0 + off + x) // 32 for x in range(i0)}
        words += len(bits)
        cells += (m - over) * i0
    steps = int((traceback.unpack_trace(out, m, fill)[4] >= 0).sum())
    got = diagnostics.trace_bound(c, out, m, fill, prof.planes,
                                  pcodes.shape[0])
    assert got["ops"] == cells + steps and steps > 0
    assert got["bytes"] == (4 * prof.planes * words + c.size * 8
                            + pcodes.numel() + 12 * (m + 1) + out.size * 4)
    assert got["bound_by"] in ("bytes", "operations") and got["bound_ms"] > 0
