#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sassy_tpu_torch) on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an sm_90a GPU (H100) and
the CUDA toolkit. Phases:

1. the card (nvidia-smi), the toolchain (features()), and the build of
   the six kernel sources (q1meta, q2meta, q1, q2, the qN family, the
   row-step ablations) from sassy_tpu_torch/csrc/ with one nvcc call;
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
   Match for Match with CIGAR;
8. overhang, single engine, word-level path, 1 GiB:
   Searcher("iupac", rc=True, alpha=0.5).search of a 23 bp pattern at
   k=3 (7 overshoot steps: the q1meta scan with its tail tile), twice:
   exact copies hanging 4 chars off the text's start and off its end, on
   one strand each and then on the other, and a mutated interior copy;
   each must come back as the port's CPU path finds it on a 50 kbp slice
   holding the same end; q1meta launched, q1 never; one strand timed;
9. q1 vs plain and the single position-level path, 1 GiB: the q1 kernel
   against its plain version on the overlaid windows of a 120 bp IUPAC
   pattern at k=10, alpha 0.1 (101 overshoot steps), bit for bit, both
   timed; then Searcher("iupac", rc=True, alpha=0.1).search of it, with
   copies hanging 10 chars off both ends, checked as in phase 8; q1
   launched, q1meta never; the device memory peak;
10. q2 vs plain: the q2 kernel against its plain version on the first
   dispatch chunk of phase 11b's position-level run (8 patterns of
   120 bp, k=10, alpha 0.1), bit for bit, each pattern's slice against
   q1; both timed;
11. batched overhang at the nanopore shape, 33,400 fresh random 10 kbp
   reads: (a) search_many of 96 x 24 bp barcodes, k=3, alpha 0.5, an
   exact barcode copy hanging 4 chars off the start or the end of every
   16th read (q2meta, never q2, q1 or q1meta); (b) search_many of
   8 x 120 bp patterns, k=10, alpha 0.1, copies hanging 10 chars off the
   ends of every 64th read (q2, never q2meta); every planted copy must
   come back with its pattern, read, strand, cost and CIGAR, and every
   read with another match, plus 64 sampled reads, is searched again on
   the port's CPU path, Match for Match; the phases of one strand are
   timed;
12. the kernel-design family (scan_qn: U patterns per thread, the row
   loop kept or unrolled, WU words per iteration) at the nanopore
   dispatch chunk of the tool's own inputs (96 x 24 bp, 8,710 pieces of
   320 words, iupac eq): every member the tool runs against the plain
   version and against q2 (scan_q), bit for bit, and timed beside its
   bound and registers; the one-pattern-per-thread member also with the
   pure and the ascii eq; then the entry point itself,
   sassy_tpu_torch.tools.kernel_qn's run() in all three modes at the
   nanopore shape and at 8 x 64 bp, which must launch every member;
13. the row-step ablations (scan_variant: full, noeq, nomem, nostore) at
   the windows of 1 GiB for a 24 bp pattern: each against its plain
   version, full's vp against q1's, timed; then
   sassy_tpu_torch.tools.kernel_variants' run(), which must launch all
   four;
14. ascii end to end at full width: 1 GiB of random printable bytes with
   a few bytes outside that range, a 28 byte pattern, case-insensitive,
   k=3, copies planted with known edits (case swapped, one substitution,
   one byte above 127, one deletion, one insertion);
   Searcher(Ascii(case_sensitive=False), device="cuda").search and
   search_all must return each with its cost and CIGAR, as the port's CPU
   path finds it on a 50 kbp slice, through q1meta with the ascii eq; the
   strand's phases timed, the device memory peak logged; then search_many
   of four ascii patterns over 2,000 texts of 10 kB against the CPU path
   on the planted texts and a sample (q2meta);
15. the hierarchical suffix prefilter: the single path at 1 GiB with an
   80 bp pattern at k=3 (32 suffix rows) and planted copies on both
   strands, with the prefilter forced on and forced off (its gate, the
   work the suffix scan must save, set to 0 and to a value no plan
   reaches): equal Match lists, the flagged tiles counted, one strand's
   device path with and without the prefilter and the prefilter's steps
   timed in turns, also for a 160 bp pattern; the batched path at the
   nanopore shape with 8 x 72 bp at k=2 (32 suffix rows), on and off,
   equal Match lists, one strand's phases timed, and its dispatch with
   and without the prefilter in turns, also over fewer reads.

The script imports neither JAX nor anything of the reference package.

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
READS_CPU = 256
Q_SINGLE = 4
READS_SINGLE = 200
#: the planted copies' one edit: a substitution at this pattern index
MUT_AT = 11
#: phases 8-11: overhang. (alpha, k, pattern length, chars a planted copy
#: hangs off a text end) of the word-level cases (7 overshoot steps) and
#: the position-level ones (101 steps)
OH_WORD = (0.5, 3, 23, 4)
OH_POS = (0.1, 10, 120, 10)
#: phase 11: planted reads of (a) and (b), reads checked on the CPU path
OH_EVERY_A = 16
OH_EVERY_B = 64
OH_Q_B = 8
OH_SAMPLE = 64

#: phase 12-13: the seed of the tools' numpy generator
TOOL_SEED = 0
#: phase 14: ascii. Pattern, texts of search_many and those checked on the
#: CPU path besides the planted ones
ASCII_PATTERN = b"The Quick Brown Fox: 42 dogs"
ASCII_TEXTS = 2_000
ASCII_SAMPLE = 64
#: phase 15: (pattern length, k) of the single and the batched prefilter
#: runs (32 suffix rows each), and the batched pattern count
HIER_SINGLE = (80, 3)
HIER_BATCH = (72, 2)
HIER_Q = 8
#: smaller read sets the batched prefilter is also timed at, and the
#: turns and launches per turn of phase 15's timings
HIER_FEWER_READS = (8192, 2048, 256)
HIER_TURNS = 3
HIER_REPS = 5
#: a gate that no plan reaches: the prefilter forced off
NEVER = 1 << 62

#: the least time of a scan kernel (the bound_ms of the kernels line): the
#: larger of its bytes over the H100's 3.35 TB/s and its integer ALU-pipe
#: instructions over that pipe's rate, 132 SMs x 64 lanes x 1.98 GHz (the
#: SXM part's boost clock; half the issue rate, while IMAD issues to the
#: FMA pipe and the U* instructions to the uniform datapath). ROW_OPS, per
#: (pattern row, window word): the ALU-pipe instructions of scan_rows' loop
#: (csrc/myers_step.cuh) in the SASS nvcc 12.8 builds for sm_90a, counted by
#: `python -m sassy_tpu_torch.tools.sass_count`, the largest over q1meta,
#: q2meta and q2 and both carry layouts; q1's loop is within 0.75 of them
#: (all instructions per row: pure 33.5, iupac 28.75, ascii 34.75). A
#: count from the source, two bitwise operations on three inputs taken as
#: one LOP3, gave pure 21, iupac 23, ascii 28. WORD_OPS, per (pattern,
#: window word) outside the rows, from
#: the source: the two popcounts and the cost update (4), with the
#: selection metadata also the owned mask, state code and screen (20 more);
#: the ablations keep one popcount and one add (2).
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ROW_OPS = {"pure": 24.25, "iupac": 22.75, "ascii": 27.25}
WORD_OPS = {False: 4, True: 24}


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


def bound(eq_mode: str, Q: int, M: int, windows_shape, meta: bool,
          vp_only: bool = False) -> dict:
    """bound_ms and bound_by of one scan launch: Q patterns of M rows
    (pad rows included: the kernel scans them) over (NW, P, T) windows.
    Bytes: the windows read once, the outputs written once (vp, vm, cost
    and, with meta, meta and final; ``vp_only``: the ablations' one word
    per window word, and no text-start flags)."""
    NW, P, T = windows_shape
    word_ops = 2 if vp_only else WORD_OPS[meta]
    n_out = 1 if vp_only else 4 if meta else 3
    ops = Q * NW * T * (M * ROW_OPS[eq_mode] + word_ops)
    nbytes = 4 * (NW * P * T + Q * NW * T * n_out
                  + (Q * T if meta else 0)) + (0 if vp_only else T)
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def counts_zero():
    """Set every kernel's launch count to 0."""
    from sassy_tpu_torch.ops import myers_cuda

    for fn in (myers_cuda.scan_meta, myers_cuda.scan_q_meta, myers_cuda.scan,
               myers_cuda.scan_q, myers_cuda.scan_qn,
               myers_cuda.scan_variant):
        fn.launches = 0
    myers_cuda.scan_qn.members = {}
    myers_cuda.scan_variant.members = {}


def counts() -> dict:
    from sassy_tpu_torch.ops import myers_cuda

    return {"q1meta": myers_cuda.scan_meta.launches,
            "q2meta": myers_cuda.scan_q_meta.launches,
            "q1": myers_cuda.scan.launches, "q2": myers_cuda.scan_q.launches,
            "qn": myers_cuda.scan_qn.launches,
            "variants": myers_cuda.scan_variant.launches}


def require(launched: dict, used: tuple, unused: tuple, what: str,
            least: int = 2):
    for name in used:
        if launched[name] < least:
            fail(f"{what} launched {name} {launched[name]} times")
    for name in unused:
        if launched[name]:
            fail(f"{what} launched {name} {launched[name]} times")


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
            head = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                    **bound(inp.eq_mode, 1, inp.pmasks.shape[0],
                            inp.windows.shape, True)}
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
            head = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                    **bound(eq_mode, pm.shape[0], pm.shape[1], win.shape,
                            True)}
        del got
    return head


def batched_strand_phases(label, searcher, prof, pats, texts, k, alpha):
    """The phases of the forward strand of a batched search: the engine's
    own dispatch, with its window, scan and selection steps timed (each
    ended by a synchronise); the first run pays one-time costs."""
    import torch

    from sassy_tpu_torch.ops import batch

    pcodes = [prof.encode(p) for p in pats]
    for run in ("cold", "warm"):
        acc = dict.fromkeys(("windows", "prefilter", "scan", "select"), 0.0)

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

        eng = batch.BatchEngine(DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts = batch.TextSet(texts, DEVICE)
        (g,) = eng.groups(prof, pcodes, ts, k, alpha)
        ts.planes(prof, False, g.steps)
        torch.cuda.synchronize()
        t_pack = time.perf_counter() - t0
        timed(ts, "windows", "windows")
        timed(eng, "flagged_pieces", "prefilter")
        timed(eng, "scan", "scan")
        timed(eng, "select", "select")
        pp = ts.piece_plan(g.halo, g.w_chars, g.steps)
        found = eng.dispatch(prof, ts, g, k, False, False)
        t0 = time.perf_counter()
        dense = batch._decode(batch._fetch(found), len(pats), len(texts),
                              False)
        t_decode = time.perf_counter() - t0
        post = "not run"  # the host traceback has no cold cost to show
        if run == "warm":
            t0 = time.perf_counter()
            ms = searcher._finish_many_batched(
                lambda: dense, None, pats, pcodes, None, None, texts, texts,
                k, None)
            post = (f"{(time.perf_counter() - t0) * 1e3:.1f} ms "
                    f"({len(ms)} matches)")
        n_chunks = len(list(eng.chunks(g, pp)))
        log(f"{label}: forward strand, {len(pats)} x {len(pats[0])} bp over "
            f"{len(texts)} x {READ_LEN} bp, {run}: upload+pack "
            f"{t_pack * 1e3:.1f} ms, piece windows "
            f"{acc['windows'] * 1e3:.1f} ms, suffix prefilter "
            f"{acc['prefilter'] * 1e3:.1f} ms, kernel "
            f"{acc['scan'] * 1e3:.1f} ms, selection {acc['select'] * 1e3:.1f} ms, host copy+decode "
            f"{t_decode * 1e3:.1f} ms, traceback+dense assembly {post} "
            f"(M={g.pmasks.shape[1]} eq={g.eq_mode} steps={g.steps} "
            f"pieces={pp.T} NW={pp.NW} chunks={n_chunks})")
        del ts, eng, found, dense


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

    batched_strand_phases("phase 6", searcher, dna, pats, texts, K, None)

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


def _rc_table():
    import numpy as np

    comp = np.arange(256, dtype=np.uint8)
    comp[list(b"ACGTRY")] = list(b"TGCAYR")
    return lambda seq: comp[seq[::-1]]


def planted_end(pattern, strand: str, where: str, hang: int, n: int):
    """An exact copy of ``pattern`` on ``strand`` hanging ``hang`` chars off
    the ``where`` end of a text of length n. Returns (offset, bytes, the
    Match's (text_start, text_end, pattern_start, pattern_end))."""
    m = len(pattern)
    seq = pattern if strand == "FWD" else _rc_table()(pattern)
    at, part = (0, seq[hang:]) if where == "start" else (
        n - (m - hang), seq[: m - hang])
    # the forward copy off the start and the reverse one off the end lose
    # the pattern's head; the others its tail
    lost_head = (strand == "FWD") == (where == "start")
    return at, part, (at, at + m - hang) + ((hang, m) if lost_head
                                             else (0, m - hang))


def single_strand_phases(label, searcher, prof, pattern, text, k):
    """The phases of one strand of a single-pattern search, each ended by a
    synchronise; the first run pays one-time costs."""
    import torch

    from sassy_tpu_torch import Strand

    eng = searcher.engine
    pcodes = prof.encode(pattern)
    names = ("upload+pack", "plan+windows", "scan kernel", "selection",
             "traceback")
    for run in ("cold", "warm"):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        prep = eng.prepare(prof, text)
        mark()
        inp = eng.build_inputs(prof, pcodes, prep, k, searcher.alpha,
                               searcher.max_overhang)
        mark()
        outs = eng.scan(inp)
        mark()
        cands = eng.select(inp, outs).cpu()
        mark()
        ends = sorted(zip(*cands.tolist()))
        searcher._postprocess(pattern, pcodes, text, k, ends, None,
                              Strand.FWD, 0, 0)
        mark()
        log(f"{label}: forward strand, {len(text) >> 20} MiB, {run}, "
            f"{'word' if inp.fast else 'position'} level (T="
            f"{inp.windows.shape[2]} NW={inp.windows.shape[0]}): "
            + ", ".join(f"{nm} {(b - a) * 1e3:.1f} ms"
                        for nm, a, b in zip(names, marks, marks[1:]))
            + f" ({len(ends)} candidates)")
        del prep, inp, outs


def fields(mt, shift: int = 0):
    return (mt.text_start + shift, mt.text_end + shift, mt.pattern_start,
            mt.pattern_end, mt.cost, mt.strand.name, mt.cigar.to_string())


def check_sites(label, matches, sites, pattern, text, k, alpha):
    """Each planted site [(strand, where, offset, want)] comes back once,
    as the port's CPU path finds it on a slice of SLICE chars holding the
    same text end (or the interior copy); an exact copy off an end also
    with its predicted span, cost floor(alpha * hang) and CIGAR."""
    from sassy_tpu_torch import Searcher

    n = len(text)
    cpu = Searcher("iupac", rc=True, alpha=alpha, device="cpu")
    for strand, where, at, want in sites:
        off = {"start": 0, "end": n - SLICE}.get(where, at - SLICE // 2)

        def pick(ms, n_here, shift):
            return [fields(x, shift) for x in ms if x.strand.name == strand
                    and {"start": x.text_start == 0,
                         "end": x.text_end == n_here}.get(
                             where, x.text_start + shift == at)]

        got = pick(matches, n, 0)
        ref = pick(cpu.search(pattern, text[off : off + SLICE], k), SLICE,
                   off)
        if len(got) != 1 or got != ref:
            fail(f"{label}: planted {strand} copy at the {where} ({at}): "
                 f"card {got}, CPU path on the slice {ref}")
        if want is not None and got[0][:5] != want:
            fail(f"{label}: planted {strand} copy at the {where}: {got[0]}, "
                 f"want {want}")
        log(f"{label}: planted {strand} copy at the {where} ({at}): found "
            f"as on the CPU path: span {got[0][:2]}, pattern {got[0][2:4]}, "
            f"cost {got[0][4]}, cigar {got[0][6]}")


def overhang_single(gen, text):
    """Phase 8: the word-level overhang path at 1 GiB."""
    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher, profiles

    alpha, k, m, hang = OH_WORD
    iupac = profiles.Iupac()
    pattern = random_acgt(gen, m).cpu().numpy()
    n = len(text)
    mid = n // 5
    mutated = pattern.copy()
    mutated[MUT_AT] = ord("A") if mutated[MUT_AT] != ord("A") else ord("C")
    text[mid : mid + m] = mutated
    searcher = Searcher("iupac", rc=True, alpha=alpha, device=DEVICE)
    cost = int(np.floor(np.float32(alpha) * np.float32(hang)))
    for variant, (s_start, s_end) in enumerate((("FWD", "RC"),
                                                 ("RC", "FWD"))):
        sites = [("FWD", "mid", mid, None)]
        for strand, where in ((s_start, "start"), (s_end, "end")):
            at, part, span = planted_end(pattern, strand, where, hang, n)
            text[at : at + len(part)] = part
            sites.append((strand, where, at, span + (cost,)))
        if variant == 0:
            single_strand_phases("phase 8", searcher, iupac, pattern, text, k)
        counts_zero()
        t0 = time.perf_counter()
        matches = searcher.search(pattern, text, k)
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        launched = counts()
        log(f"phase 8: Searcher.search with alpha {alpha}, both strands, "
            f"{n >> 20} MiB, copies {s_start} off the start and {s_end} off "
            f"the end: {e2e:.3f} s, {len(matches)} matches, launches "
            f"{launched}")
        require(launched, ("q1meta",), ("q1", "q2", "q2meta"), "phase 8")
        check_sites("phase 8", matches, sites, pattern, text, k, alpha)


def overhang_position_level(gen, text):
    """Phase 9: q1 against its plain version, and the position-level
    single path at 1 GiB. Returns q1's record."""
    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher, profiles
    from sassy_tpu_torch.ops import myers_cuda

    alpha, k, m, hang = OH_POS
    iupac = profiles.Iupac()
    planted = random_acgt(gen, m).cpu().numpy()
    pattern = planted.copy()  # two IUPAC codes: the iupac eq
    pattern[[30, 90]] = [ord("R"), ord("Y")]
    planted[30] = ord("A") if planted[30] in b"CT" else planted[30]
    planted[90] = ord("C") if planted[90] in b"AG" else planted[90]
    n = len(text)

    searcher = Searcher("iupac", rc=True, alpha=alpha, device=DEVICE)
    eng = searcher.engine
    prep = eng.prepare(iupac, text)
    inp = eng.build_inputs(iupac, iupac.encode(pattern), prep, k, alpha)
    if inp.fast or inp.eq_mode != "iupac":
        fail(f"phase 9: expected the position-level iupac path, got fast="
             f"{inp.fast} eq={inp.eq_mode}")
    args = (inp.windows, inp.tile0, inp.pmasks, inp.is_pad, inp.h_init,
            inp.m_real, inp.boundary_m, inp.eq_mode)
    got = myers_cuda.scan(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = myers_cuda.scan_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
              for a, b in zip(got, ref))
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    del got, ref
    ms = cuda_ms(lambda: myers_cuda.scan(*args), REPS)
    NW, P, T = inp.windows.shape
    log(f"phase 9: q1 vs plain: eq={inp.eq_mode} M={inp.pmasks.shape[0]} "
        f"NW={NW} P={P} T={T} (steps {inp.max_pos - inp.n_text}) kernel "
        f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bit-equal={same} "
        f"max_abs_err={err}")
    if not same:
        fail("q1 != plain")
    record = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
              **bound(inp.eq_mode, 1, inp.pmasks.shape[0], inp.windows.shape,
                      False)}
    del prep, inp, args

    mid = 2 * n // 5
    mutated = planted.copy()
    mutated[MUT_AT] = ord("A") if mutated[MUT_AT] != ord("A") else ord("C")
    text[mid : mid + m] = mutated
    cost = int(np.floor(np.float32(alpha) * np.float32(hang)))
    sites = [("FWD", "mid", mid, None)]
    for strand, where in (("FWD", "start"), ("RC", "end")):
        at, part, span = planted_end(planted, strand, where, hang, n)
        text[at : at + len(part)] = part
        sites.append((strand, where, at, span + (cost,)))
    single_strand_phases("phase 9", searcher, iupac, pattern, text, k)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts_zero()
    t0 = time.perf_counter()
    matches = searcher.search(pattern, text, k)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launched = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 9: Searcher.search with alpha {alpha}, both strands, "
        f"{n >> 20} MiB, position level: {e2e:.3f} s, {len(matches)} "
        f"matches, launches {launched}, device memory peak {peak:.2f} GiB")
    require(launched, ("q1",), ("q1meta", "q2", "q2meta"), "phase 9")
    check_sites("phase 9", matches, sites, pattern, text, k, alpha)
    record["launches"] = launched["q1"]
    return record


def overhang_reads(gen):
    """Phase 11's read set: (N_READS, READ_LEN) uint8 random ACGT."""
    return random_acgt(gen, N_READS * READ_LEN).cpu().numpy().reshape(
        N_READS, READ_LEN)


def plant_reads(reads, pats, every: int, hang: int, first: int = 0) -> dict:
    """An exact copy hanging ``hang`` chars off the start or the end of
    every ``every``-th read from ``first`` on, alternating the pattern,
    strand and end.
    Returns {(pattern, read, strand): (text_start, text_end,
    pattern_start, pattern_end)}."""
    want = {}
    for j, i in enumerate(range(first, len(reads), every)):
        q = j % len(pats)
        strand = "FWD" if j % 2 == 0 else "RC"
        where = "start" if (j // 2) % 2 == 0 else "end"
        at, part, span = planted_end(pats[q], strand, where, hang,
                                     reads.shape[1])
        reads[i, at : at + len(part)] = part
        want[(q, i, strand)] = span
    return want


def q2_vs_plain(reads, pats):
    """Phase 10: q2 against its plain version on the first dispatch chunk
    of phase 11b's position-level group. Returns the record."""
    import torch

    from sassy_tpu_torch import profiles
    from sassy_tpu_torch.ops import myers_cuda
    from sassy_tpu_torch.ops.batch import BatchEngine, TextSet

    alpha, k = OH_POS[:2]
    iupac = profiles.Iupac()
    eng = BatchEngine(DEVICE)
    ts = TextSet(list(reads), DEVICE)
    (g,) = eng.groups(iupac, [iupac.encode(p) for p in pats], ts, k, alpha)
    if g.fast:
        fail("phase 10: expected a position-level group")
    pp = ts.piece_plan(g.halo, g.w_chars, g.steps)
    q0, q1, t0, t1 = next(eng.chunks(g, pp))
    win = ts.windows(iupac, pp, False, t0, t1)
    args = (win, pp.true_start[t0:t1], g.pmasks[q0:q1], g.is_pad[q0:q1],
            g.h_init[q0:q1], g.m_real[q0:q1], g.boundary_m[q0:q1], g.eq_mode)
    got = myers_cuda.scan_q(*args)
    torch.cuda.synchronize()
    start = time.perf_counter()
    ref = myers_cuda.scan_q_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - start) * 1e3
    err = max((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
              for a, b in zip(got, ref))
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    one = all(
        all(torch.equal(a, b[q]) for a, b in zip(myers_cuda.scan(
            *args[:2], args[2][q], args[3][q], args[4][q], int(args[5][q]),
            int(args[6][q]), g.eq_mode), got))
        for q in range(q1 - q0))
    ms = cuda_ms(lambda: myers_cuda.scan_q(*args), REPS)
    NW, P, T = win.shape
    log(f"phase 10: q2 vs plain on the first of {len(list(eng.chunks(g, pp)))}"
        f" dispatch chunks: eq={g.eq_mode} Q={q1 - q0} M={g.pmasks.shape[1]} "
        f"NW={NW} P={P} T={T} (steps {g.steps}) kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bit-equal={same} max_abs_err={err}, slices "
        f"equal q1={one}")
    if not (same and one):
        fail("q2 != plain or q1")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            **bound(g.eq_mode, q1 - q0, g.pmasks.shape[1], win.shape, False)}


def batched_overhang(label, reads, pats, case, want, used, unused):
    """Phase 11a/b: search_many with overhang over the read set; every
    planted copy, then the CPU path on the reads with other matches and a
    sample. Returns the launch counts of the main-path run."""
    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher, profiles

    alpha, k, _, hang = case
    m = len(pats[0])
    texts = list(reads)
    searcher = Searcher("iupac", rc=True, alpha=alpha, device=DEVICE)
    batched_strand_phases(label, searcher, profiles.Iupac(), pats, texts, k,
                          alpha)
    counts_zero()
    t0 = time.perf_counter()
    matches = searcher.search_many(pats, texts, k)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launched = counts()
    log(f"{label}: Searcher.search_many with alpha {alpha}, both strands: "
        f"{e2e:.3f} s, {len(matches)} matches, launches {launched}")
    require(launched, used, unused, label)

    cost = int(np.floor(np.float32(alpha) * np.float32(hang)))
    cigar = f"{m - hang}="
    found = set()
    for x in matches:
        key = (x.pattern_idx, x.text_idx, x.strand.name)
        if (want.get(key) == fields(x)[:4] and x.cost == cost
                and x.cigar.to_string() == cigar):
            found.add(key)
    missing = sorted(set(want) - found)
    if missing:
        fail(f"{label}: {len(missing)} planted copies missing, e.g. "
             f"{missing[:3]}: "
             f"{[x for x in matches if x.text_idx == missing[0][1]]}")
    log(f"{label}: all {len(want)} planted copies found with their pattern, "
        f"read, strand, span, cost {cost} and cigar {cigar}")

    extra = {x.text_idx for x in matches
             if (x.pattern_idx, x.text_idx, x.strand.name) not in found}
    planted = sorted({i for _, i, _ in want})
    step = max(1, len(planted) // (OH_SAMPLE // 2))
    sample = set(planted[::step][: OH_SAMPLE // 2])
    sample |= set(range(1, len(texts), len(texts) // (OH_SAMPLE // 2)))
    reads_cpu = sorted(extra | sample)
    where = {t: i for i, t in enumerate(reads_cpu)}
    t0 = time.perf_counter()
    cpu = Searcher("iupac", rc=True, alpha=alpha, device="cpu").search_many(
        pats, [texts[t] for t in reads_cpu], k)
    t_cpu = time.perf_counter() - t0
    for x in cpu:
        x.text_idx = reads_cpu[x.text_idx]
    key = lambda x: (x.pattern_idx, x.text_idx) + fields(x)  # noqa: E731
    got = sorted(key(x) for x in matches if x.text_idx in where)
    ref = sorted(key(x) for x in cpu)
    log(f"{label}: {len(extra)} reads with other matches and "
        f"{len(reads_cpu)} reads in all against the CPU path ({t_cpu:.1f} "
        f"s): {len(got)} matches, equal={got == ref}")
    if got != ref:
        fail(f"{label}: search_many differs from the CPU path on the checked "
             "reads")
    return launched


def _equal_all(got, ref) -> tuple[bool, int]:
    """Bit equality and the largest absolute difference of two tuples of
    int32 tensors."""
    import torch

    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    err = max((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
              for a, b in zip(got, ref))
    return same, err


def qn_family():
    """Phase 12. Returns {row: record} for the kernels line: "q" (U = 1,
    loop), "qn" (U > 1, loop), "unroll" (rows unrolled, WU = 1) and
    "unroll_w" (WU > 1), each with the launches of the tool's own run."""
    import numpy as np
    import torch

    from sassy_tpu_torch.ops import myers_cuda
    from sassy_tpu_torch.tools import kernel_qn, timing

    inputs = kernel_qn.read_inputs(np.random.default_rng(TOOL_SEED), DEVICE,
                                   kernel_qn.N_BARCODES,
                                   kernel_qn.BARCODE_LEN, None, None)
    res = timing.built_resources()
    members = []
    for mode in ("main", "unroll", "wunroll"):
        members += [m for m in kernel_qn.MODES[mode] if m[1:] not in
                    [x[1:] for x in members]]
    rows = {}
    for eq in ("iupac", "pure", "ascii"):
        args = inputs[eq]
        Q, M = args[2].shape[:2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = myers_cuda.scan_qn_plain(*args, eq)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        yard = myers_cuda.scan_q(*args, eq)
        ms_q2 = cuda_ms(lambda: myers_cuda.scan_q(*args, eq), REPS)
        b = bound(eq, Q, M, args[0].shape, False)
        log(f"phase 12: eq={eq} Q={Q} M={M} NW={args[0].shape[0]} "
            f"P={args[0].shape[1]} T={args[0].shape[2]}: plain "
            f"{plain_ms:.1f} ms, scan_q (q2) {ms_q2:.3f} ms, bound "
            f"{b['bound_ms']:.3f} ms by {b['bound_by']}")
        for name, U, unroll, WU in members:
            if eq != "iupac" and (U, unroll, WU) != (1, False, 1):
                continue
            got = myers_cuda.scan_qn(*args, eq, U, unroll, WU)
            torch.cuda.synchronize()
            same, err = _equal_all(got, ref)
            same_q2, _ = _equal_all(got, yard)
            del got
            ms = cuda_ms(lambda: myers_cuda.scan_qn(*args, eq, U, unroll, WU),
                         REPS)
            regs = timing.registers(res, "scan_qn_kernel",
                                    kernel_qn.EQ_INDEX[eq], U,
                                    M if unroll else 0, WU)
            log(f"phase 12: {name} eq={eq} U={U} unroll={unroll} WU={WU}: "
                f"kernel {ms:.3f} ms ({ms / ms_q2:.3f} of q2), registers "
                f"{regs}, bit-equal to plain={same} to q2={same_q2} "
                f"max_abs_err={err}")
            if not (same and same_q2):
                fail(f"scan_qn {name} eq={eq} != plain or q2")
            row = ("q" if (U, unroll, WU) == (1, False, 1) else "qn"
                   if not unroll else "unroll" if WU == 1 else "unroll_w")
            # the kernels line takes each row's iupac member with U = 2
            # (U = 1 for "q"): the designs the reference scripts compare
            if eq == "iupac" and U == (1 if row == "q" else 2) and (
                    row not in rows):
                rows[row] = {"ms": ms, "plain_ms": plain_ms,
                             "max_abs_err": err, **b}
        del ref, yard
    del inputs
    torch.cuda.empty_cache()

    # the main path of these kernels: the tool's own entry point
    counts_zero()
    t0 = time.perf_counter()
    for shape in ("nanopore", "long"):
        kernel_qn.run(shape, ("main", "unroll", "wunroll"), DEVICE,
                      TOOL_SEED, log=lambda msg: log(f"phase 12: tool: {msg}"))
    launched = dict(myers_cuda.scan_qn.members)
    log(f"phase 12: tools.kernel_qn.run at both shapes in "
        f"{time.perf_counter() - t0:.1f} s, launches per (U, unroll, WU): "
        f"{ {str(k): v for k, v in sorted(launched.items())} }")
    for _, U, unroll, WU in members:
        if not launched.get((U, unroll, WU)):
            fail(f"the tool never launched scan_qn U={U} unroll={unroll} "
                 f"WU={WU}")
    pick = {"q": lambda m: m == (1, False, 1),
            "qn": lambda m: not m[1] and m[0] > 1,
            "unroll": lambda m: m[1] and m[2] == 1,
            "unroll_w": lambda m: m[1] and m[2] > 1}
    for row, rec in rows.items():
        rec["launches"] = sum(v for m, v in launched.items() if pick[row](m))
    torch.cuda.empty_cache()
    return rows


def row_step_ablations():
    """Phase 13. Returns the record of the ``full`` variant."""
    import numpy as np
    import torch

    from sassy_tpu_torch.ops import myers_cuda
    from sassy_tpu_torch.tools import kernel_variants, timing

    win, pm = kernel_variants.single_inputs(
        np.random.default_rng(TOOL_SEED), DEVICE, N_TEXT >> 20, None, None)
    NW, P, T = win.shape
    M = pm.shape[0]
    res = timing.built_resources()
    zeros = torch.zeros(M, dtype=torch.int32, device=DEVICE)
    q1_args = (win, torch.zeros(T, dtype=torch.bool, device=DEVICE), pm,
               zeros, torch.ones_like(zeros), M, M, "iupac")
    vp_q1 = myers_cuda.scan(*q1_args)[0]
    b = bound("iupac", 1, M, win.shape, False, vp_only=True)
    log(f"phase 13: M={M} NW={NW} P={P} T={T}: the ablations' bound "
        f"{b['bound_ms']:.3f} ms by {b['bound_by']}")
    errs = {}
    for v in myers_cuda.VARIANTS:
        got = myers_cuda.scan_variant(win, pm, v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = myers_cuda.scan_variant_plain(win, pm, v)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        same, err = _equal_all((got,), (ref,))
        if v == "full":
            same = same and torch.equal(got, vp_q1)
        del got, ref
        log(f"phase 13: {v}: plain {plain_ms:.1f} ms, bit-equal={same} "
            f"max_abs_err={err}" + (" (vp equal to q1's)" if v == "full"
                                    else ""))
        if not same:
            fail(f"scan_variant {v} != plain")
        errs[v] = (plain_ms, err)
    # timed after the comparisons, in turns: the first launches after the
    # plain versions' allocations run slow
    record = None
    for turn in range(2):
        ms_q1 = cuda_ms(lambda: myers_cuda.scan(*q1_args), REPS)
        times = {v: cuda_ms(lambda: myers_cuda.scan_variant(win, pm, v), REPS)
                 for v in myers_cuda.VARIANTS}
        log(f"phase 13: turn {turn}: scan (q1) {ms_q1:.3f} ms, " + ", ".join(
            f"{v} {ms:.3f} ms" for v, ms in times.items()))
        if record is None or times["full"] < record["ms"]:
            record = {"ms": times["full"], "plain_ms": errs["full"][0],
                      "max_abs_err": errs["full"][1], **b}
    log("phase 13: registers: " + ", ".join(
        f"{v} {timing.registers(res, 'scan_variant_kernel', i)}"
        for v, i in myers_cuda.VARIANTS.items()))
    del win, pm, vp_q1, q1_args
    torch.cuda.empty_cache()

    counts_zero()
    t0 = time.perf_counter()
    kernel_variants.run("single", DEVICE, TOOL_SEED, N_TEXT >> 20,
                        log=lambda msg: log(f"phase 13: tool: {msg}"))
    launched = dict(myers_cuda.scan_variant.members)
    log(f"phase 13: tools.kernel_variants.run in "
        f"{time.perf_counter() - t0:.1f} s, launches {launched}")
    for v in myers_cuda.VARIANTS:
        if not launched.get(v):
            fail(f"the tool never launched scan_variant {v}")
    record["launches"] = sum(launched.values())
    torch.cuda.empty_cache()
    return record


def _same_matches(got, want) -> bool:
    key = lambda m: (m.pattern_idx, m.text_idx) + fields(m)  # noqa: E731
    return sorted(map(key, got)) == sorted(map(key, want))


def ascii_end_to_end(gen):
    """Phase 14: the ascii Searcher on both engines."""
    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher, profiles

    prof = profiles.Ascii(case_sensitive=False)
    n = N_TEXT
    text = (torch.randint(32, 127, (n,), generator=gen, device=DEVICE,
                          dtype=torch.int16).to(torch.uint8).cpu().numpy())
    # bytes outside the printable range, none of them in the pattern
    odd = torch.randint(0, n, (4096,), generator=gen, device=DEVICE).cpu()
    text[odd.numpy()] = np.resize(np.array([0, 255, 128, 10], np.uint8), 4096)
    pat = np.frombuffer(ASCII_PATTERN, np.uint8).copy()
    m = len(pat)
    swap = np.frombuffer(ASCII_PATTERN.swapcase(), np.uint8)
    sub = swap.copy()
    sub[MUT_AT] = ord("#")
    high = pat.copy()
    high[MUT_AT] = 0xE9
    # (offset, bytes, cost, cigar or None where only the CPU path says)
    sites = [
        (0, swap, 0, f"{m}="),
        (n // 7, sub, 1, f"{MUT_AT}=1X{m - MUT_AT - 1}="),
        (n // 3, high, 1, f"{MUT_AT}=1X{m - MUT_AT - 1}="),
        (n // 2, np.delete(pat, 9), 1, None),
        (3 * (n // 4), np.insert(swap, 20, ord("~")), 1, None),
        (n - m, pat, 0, f"{m}="),
    ]
    for off, seq, _, _ in sites:
        text[off : off + len(seq)] = seq
    searcher = Searcher(prof, rc=False, device=DEVICE)
    if searcher.engine.build_inputs(prof, prof.encode(pat), text[:SLICE],
                                    K).eq_mode != "ascii":
        fail("phase 14: the ascii search does not run the ascii eq")
    single_strand_phases("phase 14", searcher, prof, pat, text, K)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cpu = Searcher(prof, rc=False, device="cpu")
    for fn in ("search", "search_all"):
        counts_zero()
        t0 = time.perf_counter()
        matches = getattr(searcher, fn)(pat, text, K)
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        launched = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"phase 14: Searcher(Ascii(case_sensitive=False)).{fn}, "
            f"{n >> 20} MiB: {e2e:.3f} s, {len(matches)} matches, launches "
            f"{launched}, device memory peak {peak:.2f} GiB")
        require(launched, ("q1meta",), ("q1", "q2", "q2meta", "qn",
                                        "variants"), "phase 14", least=1)
        for off, seq, cost, cigar in sites:
            lo = min(max(off - SLICE // 2, 0), n - SLICE)
            near = lambda x, base: (  # noqa: E731
                off - K <= x.text_start + base <= off + K)
            got = sorted(fields(x) for x in matches if near(x, 0))
            ref = sorted(fields(x, lo) for x in getattr(cpu, fn)(
                pat, text[lo : lo + SLICE], K) if near(x, lo))
            best = min(got, key=lambda f: f[4], default=None)
            if not got or got != ref or best[4] != cost or (
                    cigar is not None and best[6] != cigar):
                fail(f"phase 14: {fn}: planted copy at {off}: card {got}, "
                     f"CPU path on the slice {ref}, want cost {cost} cigar "
                     f"{cigar}")
            if fn == "search":
                log(f"phase 14: planted copy at {off}: found as on the CPU "
                    f"path: span {best[:2]}, cost {best[4]}, cigar {best[6]}")

    # batched: four patterns over 10 kB texts cut from the big text
    texts = list(text[: ASCII_TEXTS * READ_LEN].reshape(ASCII_TEXTS, READ_LEN)
                 .copy())
    pats = [pat, np.frombuffer(b"jumps over the lazy dog.", np.uint8),
            np.frombuffer(b"SASSY approximate search", np.uint8),
            np.frombuffer(b"0123456789 abcdefghijklm", np.uint8)]
    planted = list(range(0, ASCII_TEXTS, 97))
    for j, t in enumerate(planted):
        p = pats[j % len(pats)].copy()
        if j % 2:
            p[5] = ord("_")
        at = (j * 997) % (READ_LEN - len(p))
        texts[t][at : at + len(p)] = np.frombuffer(
            bytes(p).upper() if j % 3 == 0 else bytes(p), np.uint8)
    counts_zero()
    t0 = time.perf_counter()
    matches = searcher.search_many(pats, texts, K)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launched = counts()
    log(f"phase 14: search_many of {len(pats)} ascii patterns over "
        f"{ASCII_TEXTS} x {READ_LEN} bytes: {e2e:.3f} s, {len(matches)} "
        f"matches, launches {launched}")
    require(launched, ("q2meta",), ("q1", "q2", "q1meta", "qn", "variants"),
            "phase 14", least=1)
    hit = {x.text_idx for x in matches}
    if not set(planted) <= hit:
        fail(f"phase 14: planted texts without a match: "
             f"{sorted(set(planted) - hit)[:5]}")
    check = sorted(hit | set(range(1, ASCII_TEXTS, ASCII_TEXTS // ASCII_SAMPLE)))
    ref = cpu.search_many(pats, [texts[t] for t in check], K)
    for x in ref:
        x.text_idx = check[x.text_idx]
    checked = set(check)
    same = _same_matches([x for x in matches if x.text_idx in checked], ref)
    log(f"phase 14: {len(check)} texts against the CPU path: {len(ref)} "
        f"matches, equal={same}")
    if not same:
        fail("phase 14: ascii search_many differs from the CPU path")


def suffix_inputs(inp):
    """``inp`` with the pattern cut to its last ``hier_s`` rows, as the
    prefilter scans it (to time that launch alone)."""
    import dataclasses

    import torch

    S = inp.hier_s
    zeros = torch.zeros(S, dtype=torch.int32, device=inp.windows.device)
    return dataclasses.replace(
        inp, pmasks=inp.pmasks[-S:].contiguous(), is_pad=zeros,
        h_init=torch.ones_like(zeros), m_real=S, boundary_m=S,
        tile0=torch.zeros_like(inp.tile0), hier_s=0)


def hier_single(gen, text):
    """Phase 15a: the single engine's suffix prefilter at 1 GiB."""
    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher, profiles
    from sassy_tpu_torch.ops import plan

    m, k = HIER_SINGLE
    iupac = profiles.Iupac()
    pattern = random_acgt(gen, m).cpu().numpy()
    n = len(text)
    mutated = pattern.copy()
    mutated[MUT_AT] = ord("A") if mutated[MUT_AT] != ord("A") else ord("C")
    rc = _rc_table()
    sites = [(1000, pattern), (n // 6, mutated), (n // 2 + 77, rc(mutated)),
             (n - 3 * m, rc(pattern)), (n - m, mutated)]
    for off, seq in sites:
        text[off : off + m] = seq
    # a pattern of twice the length with the same 32 suffix rows
    longer = np.concatenate([random_acgt(gen, m).cpu().numpy(), pattern])
    text[n // 4 : n // 4 + 2 * m] = longer
    searcher = Searcher("iupac", rc=True, device=DEVICE)
    eng = searcher.engine
    default = plan.HIER_MIN_SAVED_PAIRS

    # the device path of the forward strand (scan, chain, selection) with
    # the prefilter and without, in turns, and the prefilter's steps
    prep = eng.prepare(iupac, text)
    plan.HIER_MIN_SAVED_PAIRS = 0
    for pat in (pattern, longer):
        inp = eng.build_inputs(iupac, iupac.encode(pat), prep, k)
        if inp.hier_s != plan.suffix_rows(m, k) or not inp.hier_s:
            fail(f"phase 15: expected a {plan.suffix_rows(m, k)}-row suffix, "
                 f"got {inp.hier_s}")
        ids = eng.flagged_tiles(inp)
        sub = eng.gather_tiles(inp, ids)
        suffix = suffix_inputs(inp)
        NW, _, T = inp.windows.shape
        M, S = inp.pmasks.shape[0], inp.hier_s

        def with_prefilter():
            flagged = eng.gather_tiles(inp, eng.flagged_tiles(inp))
            return eng.select(flagged, eng.scan(flagged))

        steps = {
            "prefilter on": with_prefilter,
            "prefilter off": lambda: eng.select(inp, eng.scan(inp)),
            "suffix scan + flags": lambda: eng.flagged_tiles(inp),
            "suffix kernel": lambda: eng.scan(suffix),
            "gather": lambda: eng.gather_tiles(inp, ids),
            "kernel, flagged tiles": lambda: eng.scan(sub),
            "kernel, all tiles": lambda: eng.scan(inp),
        }
        for turn in range(HIER_TURNS):
            log(f"phase 15: single, forward strand, {len(pat)} bp, turn "
                f"{turn}: M={M} S={S} eq={inp.eq_mode} T={T} NW={NW}, "
                f"{ids.numel()} flagged tiles, {(M - S) * NW * T} (row, "
                "word) pairs saved: " + ", ".join(
                    f"{name} {cuda_ms(fn, HIER_REPS):.3f} ms"
                    for name, fn in steps.items()))
        del inp, sub, suffix, steps
    del prep
    torch.cuda.empty_cache()

    results = {}
    for label, gate in (("on", 0), ("off", NEVER), ("on", 0), ("off", NEVER)):
        plan.HIER_MIN_SAVED_PAIRS = gate
        counts_zero()
        t0 = time.perf_counter()
        ms = searcher.search(pattern, text, k)
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        launched = counts()
        log(f"phase 15: Searcher.search, {m} bp, k={k}, both strands, "
            f"{n >> 20} MiB, prefilter {label}: {e2e:.3f} s, {len(ms)} "
            f"matches, launches {launched}")
        if launched["q1meta"] != (4 if label == "on" else 2):
            fail(f"phase 15: prefilter {label} launched q1meta "
                 f"{launched['q1meta']} times")
        require(launched, ("q1meta",), ("q1", "q2", "q2meta", "qn",
                                        "variants"), "phase 15")
        results.setdefault(label, ms)
    plan.HIER_MIN_SAVED_PAIRS = default
    if not _same_matches(results["on"], results["off"]):
        fail("phase 15: the single prefilter changes the matches")
    starts = {x.text_start for x in results["on"]}
    if not {off for off, _ in sites} <= starts:
        fail(f"phase 15: planted copies missing: "
             f"{sorted({off for off, _ in sites} - starts)}")
    log(f"phase 15: single: prefilter on and off return the same "
        f"{len(results['on'])} matches, all {len(sites)} planted copies "
        f"among them; the gate is {default} saved pairs")


def hier_batched(gen, reads):
    """Phase 15b: the batched engine's suffix prefilter at the nanopore
    shape, and at smaller read sets."""
    import torch

    from sassy_tpu_torch import Searcher, profiles
    from sassy_tpu_torch.ops import batch, plan

    m, k = HIER_BATCH
    iupac = profiles.Iupac()
    pats = list(random_acgt(gen, HIER_Q * m).cpu().numpy().reshape(HIER_Q, m))
    rc = _rc_table()
    planted = range(5, len(reads), 501)
    for j, i in enumerate(planted):
        p = pats[j % HIER_Q].copy()
        if j % 3:
            p[MUT_AT] = ord("A") if p[MUT_AT] != ord("A") else ord("C")
        at = (j * 1009) % (READ_LEN - m)
        reads[i, at : at + m] = p if j % 2 == 0 else rc(p)
    texts = list(reads)
    searcher = Searcher("iupac", rc=True, device=DEVICE)
    default = plan.HIER_MIN_SAVED_PAIRS
    results = {}
    for label, gate in (("on", 0), ("off", NEVER)):
        plan.HIER_MIN_SAVED_PAIRS = gate
        batched_strand_phases(f"phase 15: batched, prefilter {label}",
                              searcher, iupac, pats, texts, k, None)
        counts_zero()
        t0 = time.perf_counter()
        results[label] = searcher.search_many(pats, texts, k)
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        launched = counts()
        log(f"phase 15: Searcher.search_many, {HIER_Q} x {m} bp, k={k}, both "
            f"strands, prefilter {label}: {e2e:.3f} s, "
            f"{len(results[label])} matches, launches {launched}")
        require(launched, ("q2meta",), ("q1", "q2", "q1meta", "qn",
                                        "variants"), "phase 15")
    if not _same_matches(results["on"], results["off"]):
        fail("phase 15: the batched prefilter changes the matches")
    hit = {x.text_idx for x in results["on"]}
    if not set(planted) <= hit:
        fail(f"phase 15: planted reads without a match: "
             f"{sorted(set(planted) - hit)[:5]}")
    log(f"phase 15: batched: prefilter on and off return the same "
        f"{len(results['on'])} matches, every one of the {len(planted)} "
        f"planted reads among them; the gate is {default} saved pairs")

    # where the gate belongs: the forward strand's dispatch (windows, scans,
    # chain, selection) with the prefilter and without, in turns, for the
    # whole read set and for smaller ones
    eng = batch.BatchEngine(DEVICE)
    pcodes = [iupac.encode(p) for p in pats]
    for n_reads in (len(texts),) + HIER_FEWER_READS:
        ts = batch.TextSet(texts[:n_reads], DEVICE)
        (g,) = eng.groups(iupac, pcodes, ts, k)
        ts.planes(iupac, False)
        pp = ts.piece_plan(g.halo, g.w_chars)
        saved = sum((q1 - q0) * (g.pmasks.shape[1] - g.hier_s) * pp.NW
                    * (t1 - t0) for q0, q1, t0, t1 in eng.chunks(g, pp))

        def dispatch(gate):
            plan.HIER_MIN_SAVED_PAIRS = gate
            return eng.dispatch(iupac, ts, g, k, False, False)

        for turn in range(HIER_TURNS):
            on = cuda_ms(lambda: dispatch(0), HIER_REPS)
            off = cuda_ms(lambda: dispatch(NEVER), HIER_REPS)
            log(f"phase 15: batched dispatch, forward strand, {n_reads} "
                f"reads, turn {turn}: M={g.pmasks.shape[1]} S={g.hier_s} "
                f"pieces={pp.T} NW={pp.NW}, {saved} (row, word) pairs "
                f"saved: prefilter on {on:.3f} ms, off {off:.3f} ms")
        del ts
    plan.HIER_MIN_SAVED_PAIRS = default


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
    del reads
    torch.cuda.empty_cache()

    text = random_acgt(gen, N_TEXT).cpu().numpy()
    overhang_single(gen, text)
    head_q1 = overhang_position_level(gen, text)
    del text
    torch.cuda.empty_cache()

    reads = overhang_reads(gen)
    barcodes = random_acgt(gen, N_BARCODES * BARCODE_LEN).cpu().numpy()
    barcodes = list(barcodes.reshape(N_BARCODES, BARCODE_LEN))
    long_ = random_acgt(gen, OH_Q_B * OH_POS[2]).cpu().numpy()
    long_ = list(long_.reshape(OH_Q_B, OH_POS[2]))
    want_a = plant_reads(reads, barcodes, OH_EVERY_A, OH_WORD[3])
    want_b = plant_reads(reads, long_, OH_EVERY_B, OH_POS[3],
                         first=OH_EVERY_A // 2)
    head_q2 = q2_vs_plain(reads, long_)
    torch.cuda.empty_cache()
    batched_overhang("phase 11a", reads, barcodes, OH_WORD, want_a,
                     ("q2meta",), ("q2", "q1", "q1meta"))
    launched_b = batched_overhang("phase 11b", reads, long_, OH_POS, want_b,
                                  ("q2",), ("q2meta", "q1", "q1meta"))
    del reads
    torch.cuda.empty_cache()

    rows_qn = qn_family()
    head_variants = row_step_ablations()
    ascii_end_to_end(gen)
    torch.cuda.empty_cache()
    text = random_acgt(gen, N_TEXT).cpu().numpy()
    hier_single(gen, text)
    del text
    torch.cuda.empty_cache()
    hier_batched(gen, overhang_reads(gen))

    ref = [m for m in sys.modules if m in ("jax", "sassy_tpu")
           or m.startswith(("jax.", "sassy_tpu."))]
    if ref:
        fail(f"JAX or the reference package was imported: {ref}")

    def entry(name, source, replaces, launched, rec):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launched,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None}

    record = {"kernels": [
        entry("scan_meta (q1meta)", "sassy_tpu_torch/csrc/scan_meta.cu",
              "sassy_tpu/ops/myers_pallas.py:201", launches, head),
        entry("scan_q_meta (q2meta)", "sassy_tpu_torch/csrc/scan_q_meta.cu",
              "sassy_tpu/ops/myers_pallas.py:735", launches_q, head_q),
        entry("scan (q1)", "sassy_tpu_torch/csrc/scan.cu",
              "sassy_tpu/ops/myers_pallas.py:49", head_q1["launches"],
              head_q1),
        entry("scan_q (q2)", "sassy_tpu_torch/csrc/scan_q.cu",
              "sassy_tpu/ops/myers_pallas.py:541", launched_b["q2"],
              head_q2),
        entry("scan_qn U=1 loop WU=1 (q)", "sassy_tpu_torch/csrc/scan_qn.cu",
              "sassy_tpu/ops/myers_pallas.py:400", rows_qn["q"]["launches"],
              rows_qn["q"]),
        entry("scan_qn U=2 loop WU=1 (qN)", "sassy_tpu_torch/csrc/scan_qn.cu",
              "scripts/kernel_qn.py:17", rows_qn["qn"]["launches"],
              rows_qn["qn"]),
        entry("scan_qn U=2 unroll WU=1", "sassy_tpu_torch/csrc/scan_qn.cu",
              "scripts/kernel_qn.py:183", rows_qn["unroll"]["launches"],
              rows_qn["unroll"]),
        entry("scan_qn U=2 unroll WU=2", "sassy_tpu_torch/csrc/scan_qn.cu",
              "scripts/kernel_qn.py:345", rows_qn["unroll_w"]["launches"],
              rows_qn["unroll_w"]),
        entry("scan_variant full", "sassy_tpu_torch/csrc/scan_variants.cu",
              "scripts/kernel_variants.py:29", head_variants["launches"],
              head_variants),
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
