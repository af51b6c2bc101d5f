#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sassy_tpu_torch) on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an sm_90a GPU (H100) and
the CUDA toolkit. Phases:

1. the card (nvidia-smi), the toolchain (features()), and the build of
   both scan kernels (q1meta, q2meta) from sassy_tpu_torch/csrc/ with
   one nvcc call;
2. kernel vs plain: the q1meta scan kernel against its plain PyTorch
   version on the windows of a 1 GiB text (the H100 tile plan, a 23 bp
   pattern at k=3), bit for bit on all five outputs, for the pure, iupac
   and ascii eq and for a 100 bp pattern (M > 64); both timed;
3. end to end at full size: Searcher("dna", rc=True, device="cuda")
   .search over 1 GiB of random ACGT with mutated copies of the pattern
   planted on both strands; every copy must come back, through the
   kernel, with the cost and CIGAR of its one planted substitution; the
   phases of one strand are timed;
4. end to end, the card against the port's CPU path (the plain version
   of the kernel) on a 50 kbp slice: search and search_all at k in
   {0, 1, 3}, Match for Match with CIGAR. The CPU path is held to the
   numpy oracle by tests/test_torch_search.py, and the card to it by
   tests/test_torch_cuda.py;
5. kernel vs plain, batched: the q2meta kernel against its plain version
   on the piece windows of one dispatch chunk of phase 6 below (its
   first ~8.7k pieces of 321 words), k=3, bit for bit on all five
   outputs: first that chunk exactly as phase 6 launches it (all 96
   barcodes), then Q = 8 patterns of one row bucket with different
   lengths for pure, iupac, ascii and 97-104 bp patterns (M > 64); each
   pattern's slice also against the q1meta kernel; both timed;
6. end to end at full size, batched: the nanopore shape of
   evals/configs/nanopore_full.toml, 96 random 24 bp barcodes against
   33,400 random 10 kbp reads (334 Mbp), k=3, through
   Searcher("dna", rc=True, device="cuda").search_many; every read holds
   one barcode copy with one substitution at offset 5000 (even reads on
   the forward strand, odd reads as the reverse complement), and each
   must come back with its pattern, read, strand, cost 1 and CIGAR,
   through q2meta and never q1meta; every read with any other match, and
   a sample of the others, is searched again on the port's CPU path (the
   plain versions), Match for Match with CIGAR; the phases of one strand
   are timed, and the async dispatch is shown to return before its work;
7. batched vs single on the card: 4 barcodes over 200 reads, search_many
   against the per-pair Searcher.search results (q1meta), and
   search_encoded_patterns(rc_anchor="end") against per-pattern search,
   Match for Match with CIGAR.

The script imports neither JAX nor the reference package's engines.

Progress goes to stdout. The line before the last is the kernels' JSON
record; the last line is {"ok": true, "device": {...}}. Any failure exits
non-zero without that line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

DEVICE = "cuda"
SEED = 0
N_TEXT = 1 << 30
K = 3
PATTERN_LEN = 23
LONG_PATTERN_LEN = 100
SLICE = 50_000
REPS = 10
#: the nanopore read set (evals/configs/nanopore_full.toml)
N_BARCODES = 96
BARCODE_LEN = 24
N_READS = 33_400
READ_LEN = 10_000
PLANT_AT = 5_000
#: phase 5's pattern batch, phase 6's reads checked on the CPU path, and
#: phase 7's pairs
Q_KERNEL = 8
READS_CPU = 512
Q_SINGLE = 4
READS_SINGLE = 200
#: the planted copies' one edit: a substitution at this pattern index
MUT_AT = 11


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_acgt(gen, n: int):
    import torch

    bases = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=DEVICE)
    return bases[torch.randint(0, 4, (n,), generator=gen, device=DEVICE)]


def kernel_vs_plain(gen, text_dev):
    """Phase 2. Returns the headline (pure) record: times and error."""
    import torch

    from sassy_tpu_torch import profiles
    from sassy_tpu_torch.ops import myers_cuda
    from sassy_tpu_torch.ops.myers_torch import TorchEngine

    eng = TorchEngine(DEVICE)
    dna = profiles.Dna()
    pattern = random_acgt(gen, PATTERN_LEN).cpu().numpy()
    long_pattern = random_acgt(gen, LONG_PATTERN_LEN).cpu().numpy()
    t0 = time.perf_counter()
    prep = eng.prepare(dna, text_dev)
    prep_ascii = eng.prepare(profiles.Ascii(), text_dev)
    torch.cuda.synchronize()
    log(f"phase 2: packed {N_TEXT >> 20} MiB for dna and ascii in "
        f"{time.perf_counter() - t0:.3f} s")
    cases = [
        ("pure", dna, prep, pattern),
        ("iupac", dna, prep, pattern),
        ("ascii", profiles.Ascii(), prep_ascii, pattern),
        ("pure, M>64", dna, prep, long_pattern),
    ]
    head = None
    for label, prof, p, pat in cases:
        inp = eng.build_inputs(prof, prof.encode(pat), p, K)
        if label == "iupac":
            inp.eq_mode = "iupac"
        args = (inp.windows, inp.tile0, inp.valid_from, inp.valid_to,
                inp.pmasks, inp.is_pad, inp.h_init, inp.m_real,
                inp.boundary_m, inp.k, inp.eq_mode)
        got = myers_cuda.scan_meta(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = myers_cuda.scan_meta_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(
            (a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
            for a, b in zip(got, ref)
        )
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        ms = cuda_ms(lambda: myers_cuda.scan_meta(*args), REPS)
        NW, P, T = inp.windows.shape
        log(f"phase 2: {label}: eq={inp.eq_mode} M={inp.pmasks.shape[0]} "
            f"NW={NW} P={P} T={T} kernel {ms:.3f} ms, plain {plain_ms:.1f} ms,"
            f" bit-equal={same} max_abs_err={err}")
        if not same:
            fail(f"kernel != plain for {label}")
        if head is None:
            head = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
        del got, ref
    return head


def plant(text, pattern, rc_pattern, n: int):
    """Mutated copies (one substitution, as bench.py plants them) on both
    strands at fixed offsets. Returns [(strand, start)]."""
    mutated = pattern.copy()
    mutated[MUT_AT] = ord("A") if mutated[MUT_AT] != ord("A") else ord("C")
    rc_mut = rc_pattern(mutated)
    sites = [("FWD", 12345, mutated), ("FWD", n // 2, mutated),
             ("RC", n // 3, rc_mut), ("RC", n - 5000, rc_mut)]
    for _, off, seq in sites:
        text[off : off + len(seq)] = seq
    return [(s, off) for s, off, _ in sites]


def end_to_end(gen):
    """Phase 3. Returns the kernel's launch count in the main-path run."""
    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher, Strand, profiles
    from sassy_tpu_torch.ops import myers_cuda

    dna = profiles.Dna()
    pattern = random_acgt(gen, PATTERN_LEN).cpu().numpy()
    text = random_acgt(gen, N_TEXT).cpu().numpy()
    rc = lambda s: np.frombuffer(dna.reverse_complement(s), np.uint8)  # noqa: E731
    sites = plant(text, pattern, rc, N_TEXT)
    searcher = Searcher("dna", rc=True, device=DEVICE)
    eng = searcher.engine
    pcodes = dna.encode(pattern)

    # the phases of the forward strand, each ended by a synchronise; the
    # first run pays one-time costs (allocator growth, first launches)
    names = ("upload+pack", "windows", "scan kernel", "selection",
             "traceback")
    for run in ("cold", "warm"):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        prep = eng.prepare(dna, text)
        mark()
        inp = eng.build_inputs(dna, pcodes, prep, K)
        mark()
        outs = eng.scan(inp)
        mark()
        cands = eng.select(inp, outs).cpu()
        mark()
        ends = sorted(zip(*cands.tolist()))
        searcher._postprocess(pattern, pcodes, text, K, ends, None,
                              Strand.FWD, 0, 0)
        mark()
        log(f"phase 3: forward strand, {N_TEXT >> 20} MiB, {run}: "
            + ", ".join(f"{nm} {(b - a) * 1e3:.1f} ms"
                        for nm, a, b in zip(names, marks, marks[1:]))
            + f" ({len(ends)} candidates)")
        del prep, inp, outs

    myers_cuda.scan_meta.launches = 0
    t0 = time.perf_counter()
    matches = searcher.search(pattern, text, K)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = myers_cuda.scan_meta.launches
    log(f"phase 3: Searcher.search, both strands, {N_TEXT >> 20} MiB: "
        f"{e2e:.3f} s, "
        f"{len(matches)} matches, scan kernel launches {launches}")
    if launches < 2:
        fail(f"the search launched the scan kernel {launches} times")

    # each planted copy, aligned as it was planted: one substitution
    m = PATTERN_LEN
    want_cigar = f"{MUT_AT}=1X{m - MUT_AT - 1}="
    for strand, off in sites:
        got = [x for x in matches
               if x.text_start == off and x.strand.name == strand]
        if len(got) != 1:
            fail(f"planted {strand} copy at {off}: got {got}")
        g = got[0]
        if (g.text_end != off + m or g.cost != 1
                or g.cigar.to_string() != want_cigar):
            fail(f"planted {strand} copy at {off}: {g}, want cost 1, "
                 f"cigar {want_cigar}")
        log(f"phase 3: planted {strand} copy at {off}: found, cost {g.cost}, "
            f"cigar {g.cigar.to_string()}")
    return launches, text, pattern


def against_cpu(text, pattern):
    """Phase 4: the port on the card equals its CPU path."""
    from sassy_tpu_torch import Searcher, profiles

    mid = len(text) // 2
    piece = text[mid - SLICE // 2 : mid + SLICE // 2].copy()
    # exact copies on both strands, beside the mutated one at the middle
    rc = profiles.Dna().reverse_complement(pattern)
    piece[1000 : 1000 + len(pattern)] = pattern
    piece[3000 : 3000 + len(pattern)] = list(rc)
    port = Searcher("dna", rc=True, device=DEVICE)
    plain = Searcher("dna", rc=True, device="cpu")
    for k in (0, 1, 3):
        for fn in ("search", "search_all"):
            got = getattr(port, fn)(pattern, piece, k)
            want = getattr(plain, fn)(pattern, piece, k)
            same = bool(want) and len(got) == len(want) and all(
                a.same_as(b) and a.cigar.to_string() == b.cigar.to_string()
                for a, b in zip(got, want)
            )
            log(f"phase 4: {fn} k={k}: {len(got)} matches, equal={same}")
            if not same:
                fail(f"{fn} k={k} differs from the CPU path")


def nanopore_reads(gen):
    """Phase 6's read set: (N_READS, READ_LEN) uint8 random ACGT, the
    barcodes, and one mutated barcode copy planted in every read."""
    import numpy as np

    reads = random_acgt(gen, N_READS * READ_LEN).cpu().numpy().reshape(
        N_READS, READ_LEN)
    barcodes = random_acgt(gen, N_BARCODES * BARCODE_LEN).cpu().numpy()
    barcodes = barcodes.reshape(N_BARCODES, BARCODE_LEN)
    mutated = barcodes.copy()
    col = mutated[:, MUT_AT]
    mutated[:, MUT_AT] = np.where(col != ord("A"), ord("A"), ord("C"))
    comp = np.arange(256, dtype=np.uint8)
    comp[list(b"ACGT")] = list(b"TGCA")
    rc_mutated = comp[mutated[:, ::-1]]
    i = np.arange(N_READS)
    site = slice(PLANT_AT, PLANT_AT + BARCODE_LEN)
    reads[0::2, site] = mutated[i[0::2] % N_BARCODES]
    reads[1::2, site] = rc_mutated[i[1::2] % N_BARCODES]
    return reads, barcodes


def q_kernel_vs_plain(reads, barcodes):
    """Phase 5. Returns the headline (pure) record: times and error."""
    import torch

    from sassy_tpu_torch import profiles
    from sassy_tpu_torch.ops import myers_cuda
    from sassy_tpu_torch.ops.batch import BatchEngine, TextSet

    eng = BatchEngine(DEVICE)
    texts = list(reads)
    dna, ascii_ = profiles.Dna(), profiles.Ascii()
    ts = TextSet(texts, DEVICE)
    # phase 6's piece plan and its first dispatch chunk
    (g96,) = eng.groups(dna, [dna.encode(p) for p in barcodes], ts, K)
    pp = ts.piece_plan(g96.halo, g96.w_chars)
    q0, q1, t0, t1 = next(eng.chunks(g96, pp))
    tiles = slice(t0, t1)
    # 8 patterns of one row bucket, 24 down to 17 bp: mixed m_real
    short = [barcodes[q, : BARCODE_LEN - q] for q in range(Q_KERNEL)]
    long_ = [reads[q, 100 : 204 - q] for q in range(Q_KERNEL)]  # M = 104
    g_dna = eng.groups(dna, [dna.encode(p) for p in short], ts, K)[0]
    start = time.perf_counter()
    win_dna = ts.windows(dna, pp, False, t0, t1)
    win_ascii = ts.windows(ascii_, pp, False, t0, t1)
    torch.cuda.synchronize()
    log(f"phase 5: windows of pieces {t0}..{t1} of {pp.T} for dna and ascii "
        f"in {time.perf_counter() - start:.3f} s")
    # the first case is phase 6's first launch, as BatchEngine.scan issues
    # it: patterns q0..q1 of the 96
    cases = [
        ("pure, phase 6's chunk", g96, slice(q0, q1), win_dna),
        ("pure", g_dna, slice(None), win_dna),
        ("iupac", g_dna, slice(None), win_dna),
        ("ascii", eng.groups(ascii_, [ascii_.encode(p) for p in short], ts,
                             K)[0], slice(None), win_ascii),
        ("pure, M>64", eng.groups(dna, [dna.encode(p) for p in long_], ts,
                                  K)[0], slice(None), win_dna),
    ]
    head = None
    for label, g, qs, win in cases:
        eq_mode = "iupac" if label == "iupac" else g.eq_mode
        args = (win, pp.true_start[tiles], pp.valid_from[tiles],
                pp.valid_to[tiles], g.pmasks[qs], g.is_pad[qs], g.h_init[qs],
                g.m_real[qs], g.boundary_m[qs], K, eq_mode)
        got = myers_cuda.scan_q_meta(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = myers_cuda.scan_q_meta_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(
            (a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
            for a, b in zip(got, ref)
        )
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        del ref
        # each pattern's slice against the q1meta kernel
        pm, pad, hi, mr, bm = args[4:9]
        q1 = all(
            all(torch.equal(a, b[q]) for a, b in zip(myers_cuda.scan_meta(
                *args[:4], pm[q], pad[q], hi[q], int(mr[q]), int(bm[q]), K,
                eq_mode), got))
            for q in range(pm.shape[0])
        )
        ms = cuda_ms(lambda: myers_cuda.scan_q_meta(*args), REPS)
        NW, P, T = win.shape
        m_real = sorted(set(mr.tolist()))
        log(f"phase 5: {label}: eq={eq_mode} Q={pm.shape[0]} M={pm.shape[1]} "
            f"m_real={m_real} NW={NW} P={P} T={T} kernel "
            f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bit-equal={same} "
            f"max_abs_err={err}, slices equal q1meta={q1}")
        if not (same and q1):
            fail(f"q2meta != plain or q1meta for {label}")
        if head is None:
            head = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
        del got
    return head


def batched_end_to_end(reads, barcodes):
    """Phase 6. Returns the q2meta launch count of the main-path run."""
    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher, profiles
    from sassy_tpu_torch.ops import batch, myers_cuda

    dna = profiles.Dna()
    texts = list(reads)
    pats = list(barcodes)
    pcodes = [dna.encode(p) for p in pats]
    searcher = Searcher("dna", rc=True, device=DEVICE)

    # the phases of the forward strand: the engine's own dispatch, with
    # its window, scan and selection steps timed (each ended by a
    # synchronise); the first run pays one-time costs
    for run in ("cold", "warm"):
        acc = dict.fromkeys(("windows", "scan", "select"), 0.0)

        def timed(obj, name, key):
            fn = getattr(obj, name)

            def wrapper(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                acc[key] += time.perf_counter() - t0
                return out
            setattr(obj, name, wrapper)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts = batch.TextSet(texts, DEVICE)
        ts.planes(dna, False)
        torch.cuda.synchronize()
        t_pack = time.perf_counter() - t0
        eng = batch.BatchEngine(DEVICE)
        timed(ts, "windows", "windows")
        timed(eng, "scan", "scan")
        timed(eng, "select", "select")
        (g,) = eng.groups(dna, pcodes, ts, K)
        pp = ts.piece_plan(g.halo, g.w_chars)
        found = eng.dispatch(dna, ts, g, K, False, False)
        t0 = time.perf_counter()
        dense = batch._decode(batch._fetch(found), len(pats), len(texts),
                              False)
        t_decode = time.perf_counter() - t0
        post = "not run"  # the host traceback has no cold cost to show
        if run == "warm":
            t0 = time.perf_counter()
            ms = searcher._finish_many_batched(
                lambda: dense, None, pats, pcodes, None, None, texts, texts,
                K, None)
            post = (f"{(time.perf_counter() - t0) * 1e3:.1f} ms "
                    f"({len(ms)} matches)")
        n_chunks = len(list(eng.chunks(g, pp)))
        log(f"phase 6: forward strand, {N_BARCODES} x {BARCODE_LEN} bp over "
            f"{N_READS} x {READ_LEN} bp, {run}: upload+pack "
            f"{t_pack * 1e3:.1f} ms, piece windows "
            f"{acc['windows'] * 1e3:.1f} ms, kernel {acc['scan'] * 1e3:.1f} "
            f"ms, selection {acc['select'] * 1e3:.1f} ms, host copy+decode "
            f"{t_decode * 1e3:.1f} ms, traceback+dense assembly {post} "
            f"(M={g.pmasks.shape[1]} eq={g.eq_mode} pieces={pp.T} "
            f"NW={pp.NW} chunks={n_chunks})")
        del ts, eng, found, dense

    # the async dispatch returns before its device work ends: dispatch
    # both strands, then wait for each
    eng = batch.BatchEngine(DEVICE)
    ts = batch.TextSet(texts, DEVICE)
    ccodes = [dna.encode(np.frombuffer(dna.complement(p), np.uint8))
              for p in pats]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin = eng.candidates_many_async(dna, pcodes, ts, K)
    rfin = eng.candidates_many_async(dna, ccodes, ts, K, reverse=True)
    t1 = time.perf_counter()
    fin()
    t2 = time.perf_counter()
    rfin()
    t3 = time.perf_counter()
    log(f"phase 6: candidates_many_async of both strands returned in "
        f"{(t1 - t0) * 1e3:.1f} ms; the forward finish() after "
        f"{(t2 - t0) * 1e3:.1f} ms, the reverse after {(t3 - t0) * 1e3:.1f} "
        "ms")
    del eng, ts

    myers_cuda.scan_q_meta.launches = 0
    myers_cuda.scan_meta.launches = 0
    t0 = time.perf_counter()
    matches = searcher.search_many(pats, texts, K)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = myers_cuda.scan_q_meta.launches
    single = myers_cuda.scan_meta.launches
    log(f"phase 6: Searcher.search_many, both strands: {e2e:.3f} s, "
        f"{len(matches)} matches, q2meta launches {launches}, q1meta "
        f"launches {single}")
    if launches < 2 or single:
        fail(f"search_many launched q2meta {launches} and q1meta {single} "
             "times")

    want_cigar = f"{MUT_AT}=1X{BARCODE_LEN - MUT_AT - 1}="
    planted = {}
    for m in matches:
        if m.text_start == PLANT_AT:
            planted.setdefault((m.pattern_idx, m.text_idx, m.strand.name),
                               []).append(m)
    for i in range(N_READS):
        key = (i % N_BARCODES, i, "FWD" if i % 2 == 0 else "RC")
        got = planted.get(key, [])
        if (len(got) != 1 or got[0].cost != 1
                or got[0].text_end != PLANT_AT + BARCODE_LEN
                or got[0].cigar.to_string() != want_cigar):
            fail(f"planted copy {key}: got {got}, want cost 1, cigar "
                 f"{want_cigar}")
    log(f"phase 6: all {N_READS} planted copies found with their pattern, "
        f"read, strand, cost 1 and cigar {want_cigar}")

    # every read with a match besides its planted copy, and a sample of the
    # rest, against the port's CPU path (the plain kernel versions)
    extra = {m.text_idx for m in matches
             if m.text_start != PLANT_AT or m.pattern_idx != m.text_idx
             % N_BARCODES or m.strand.name != ("FWD", "RC")[m.text_idx % 2]}
    reads_cpu = sorted(extra | set(range(0, N_READS, N_READS // READS_CPU)))
    where = {t: i for i, t in enumerate(reads_cpu)}
    t0 = time.perf_counter()
    cpu = Searcher("dna", rc=True, device="cpu").search_many(
        pats, [texts[t] for t in reads_cpu], K)
    t_cpu = time.perf_counter() - t0
    for m in cpu:
        m.text_idx = reads_cpu[m.text_idx]
    key = lambda m: (m.pattern_idx, m.text_idx, m.strand.name,  # noqa: E731
                     m.text_start, m.text_end, m.cost)
    got = sorted((m for m in matches if m.text_idx in where), key=key)
    cpu.sort(key=key)
    same = len(got) == len(cpu) and all(
        a.same_as(b) and a.cigar.to_string() == b.cigar.to_string()
        for a, b in zip(got, cpu))
    log(f"phase 6: {len(extra)} reads with other matches "
        f"({len(matches) - N_READS} matches) and {len(reads_cpu)} reads in "
        f"all against the CPU path ({t_cpu:.1f} s): {len(got)} matches, "
        f"equal={same}")
    if not same:
        fail("search_many differs from the CPU path on the checked reads")
    return launches


def batched_vs_single(reads, barcodes):
    """Phase 7: the batched engine equals the per-pair single-pattern
    engine on the card."""
    from sassy_tpu_torch import Searcher

    searcher = Searcher("dna", rc=True, device=DEVICE)
    pats = list(barcodes[:Q_SINGLE])
    texts = list(reads[:READS_SINGLE])
    key = lambda m: (m.pattern_idx, m.text_idx, m.strand.name,  # noqa: E731
                     m.text_start, m.text_end, m.cost)

    def same(got, want):
        got, want = sorted(got, key=key), sorted(want, key=key)
        return bool(want) and len(got) == len(want) and all(
            a.same_as(b) and a.cigar.to_string() == b.cigar.to_string()
            for a, b in zip(got, want))

    batched = searcher.search_many(pats, texts, K)
    single = []
    for qi, p in enumerate(pats):
        for ti, t in enumerate(texts):
            for m in searcher.search(p, t, K):
                m.pattern_idx, m.text_idx = qi, ti
                single.append(m)
    ok = same(batched, single)
    log(f"phase 7: search_many {len(pats)} x {len(texts)} reads: "
        f"{len(batched)} matches, per-pair search {len(single)}, equal={ok}")
    if not ok:
        fail("search_many differs from the per-pair single-pattern search")

    text = reads[:READS_SINGLE].reshape(-1)
    enc = searcher.encode_patterns(pats, rc_anchor="end")
    batched = searcher.search_encoded_patterns(enc, text, K)
    single = []
    for qi, p in enumerate(pats):
        for m in searcher.search(p, text, K):
            m.pattern_idx = qi
            single.append(m)
    ok = same(batched, single)
    log(f"phase 7: search_encoded_patterns(rc_anchor='end') over "
        f"{len(text)} bp: {len(batched)} matches, per-pattern search "
        f"{len(single)}, equal={ok}")
    if not ok:
        fail("search_encoded_patterns differs from per-pattern search")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import sassy_tpu_torch
    from sassy_tpu_torch.ops import myers_cuda

    log(card_line())
    log(f"features: {json.dumps(sassy_tpu_torch.features())}")
    t0 = time.perf_counter()
    lib = myers_cuda.build()
    log(f"phase 1: built {lib.name} in {time.perf_counter() - t0:.1f} s")
    log(lib.with_name(lib.name + ".log").read_text().strip())

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    text_dev = random_acgt(gen, N_TEXT)
    head = kernel_vs_plain(gen, text_dev)
    del text_dev
    torch.cuda.empty_cache()

    launches, text, pattern = end_to_end(gen)
    against_cpu(text, pattern)
    del text

    reads, barcodes = nanopore_reads(gen)
    head_q = q_kernel_vs_plain(reads, barcodes)
    torch.cuda.empty_cache()
    launches_q = batched_end_to_end(reads, barcodes)
    batched_vs_single(reads, barcodes)
    engines = [m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "sassy_tpu.ops.myers", "sassy_tpu.ops.minima",
         "sassy_tpu.ops.batch", "sassy_tpu.parallel"))]
    if engines:
        fail(f"JAX or the reference engines were imported: {engines}")

    record = {"kernels": [{
        "name": "scan_meta (q1meta)",
        "route": "cuda",
        "source": "sassy_tpu_torch/csrc/scan_meta.cu",
        "replaces": "sassy_tpu/ops/myers_pallas.py:201",
        "launches": launches,
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
    }, {
        "name": "scan_q_meta (q2meta)",
        "route": "cuda",
        "source": "sassy_tpu_torch/csrc/scan_q_meta.cu",
        "replaces": "sassy_tpu/ops/myers_pallas.py:735",
        "launches": launches_q,
        "max_abs_err": head_q["max_abs_err"],
        "ms": head_q["ms"],
        "plain_ms": head_q["plain_ms"],
    }]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
