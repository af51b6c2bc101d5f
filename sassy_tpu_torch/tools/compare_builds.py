"""Time the scan kernels of two checkouts of the port on one GPU, in turns.

    python -m sassy_tpu_torch.tools.compare_builds OLD_ROOT NEW_ROOT \
        [--turns 2] [--q2-reads N]
        [--off-target] [--search-many N [--plant]] [--overhang-reads N]
        [--pack-set] [--strands] [--overhang-search] [--no-scans]
        [--cli-search N [--cli-v2] [--cli-profile]] [--out FILE]

Each run is a fresh process that imports the ``sassy_tpu_torch`` of one
checkout root, builds that checkout's kernel library from its own sources,
and times its kernels with CUDA events (mean of ``--reps`` launches after
one warm-up), at ``chip_smoke.py``'s shapes, on the windows as that
checkout's engines hand them to the kernels (a window tensor, or a
descriptor of the planes where the checkout has ``TextSet.descriptor``):

- the device memory that ``TorchEngine.prepare`` and one
  ``build_inputs`` of 1 GiB of random ACGT hold, and the host-clock time
  of ``build_inputs`` on a prepared text with its window cache cleared
  (the plan and the windows, or their descriptors; the mean of
  ``--reps``, each ended by a synchronise);
- q1meta (``scan_meta``) over the windows of that text, a 23 bp pattern
  at k=3, for the pure and the iupac eq (phase 2's headline), and for
  the ascii eq over the same bytes packed by the ascii profile;
- q1 (``scan``), where the checkout has it, over the overlaid windows of
  that text for a 120 bp IUPAC pattern at k=10, alpha 0.1 (phase 9's
  shape);
- q2meta (``scan_q_meta``), where the checkout has it, on the first
  dispatch chunk of the nanopore read set: 96 random 24 bp barcodes over
  10 kbp reads, k=3, as ``BatchEngine.scan`` launches it (phase 5's
  headline);
- with ``--q2-reads N``, q2 (``scan_q``) on the first dispatch chunk of 8
  random 120 bp patterns at k=10, alpha 0.1 over N random 10 kbp reads
  (phase 10's shape at N = 33,400);
- with ``--off-target``, q2meta on one full dispatch chunk of
  ``evals/configs/off_targets_full.toml``'s shape as ``chip_smoke.py``
  phase 5 makes it: 312 random 23 bp guides over 28 Mbp of random bases,
  in pieces of the width the batched engine gives 3.12 Gbp;
- with ``--search-many N``, where the checkout has the batched engine:
  ``Searcher("dna", rc=True).search_many`` of the 96 barcodes over N
  random 10 kbp reads, both strands, end to end (host clock,
  ``SEARCH_MANY_RUNS`` calls), and, for
  the first and the second call in the process, the time
  ``candidates_many_async`` of both strands takes to return and to
  finish, the preparation of a fresh set's planes of both strands
  (twice, host clock) and the host memory a third one allocates
  (``tracemalloc``: numpy's arrays and Python's objects), and of that
  preparation the set's upload (``TextSet.data``: ms and GB/s) apart
  from the set's constructor and both strands' packs, where the
  checkout has ``TextSet.data`` ("absent" where not); with
  ``--plant`` as well, each read holds one copy of a barcode
  with one substitution at offset 5000 (read i: barcode i % 96, even
  reads forward, odd reads reverse-complemented, as ``chip_smoke.py``
  phase 6 plants them), so that the host traceback of one match per read
  takes most of the call; with the host finish's split where the
  checkout has ``Searcher.last_finish_split``, and a digest of the Match list
  (every field and the CIGAR, in order) to compare the checkouts;
- with ``--overhang-reads N``, where the checkout has overhang on the
  batched engine: the forward strand of ``chip_smoke.py`` phase 11b's
  position-level dispatch, 8 random 120 bp patterns at k=10, alpha 0.1
  (101 overshoot steps: the q2 kernel) over N random 10 kbp reads, run
  twice (cold, warm): ``BatchEngine.dispatch`` with its window gathers,
  scan launches and selections each timed on the host clock and ended by
  a synchronise, and their counts.

- with ``--pack-set``: the text set's pack kernel (``batch.pack_set``,
  DNA, both strands) on three sets of random ACGT made on the card: one
  text of off_targets_full's 3.12 Gbp, nanopore_full's 33,400 x 10 kbp
  reads and pattern_scaling's 671,088 x 50 bp texts (its 50 bp row,
  amortised to 33,554,432 bp); each beside its bound (the bytes read
  once, the planes written once, the tables read once, at
  ``diagnostics.MEM_BYTES_PER_S``) with a checksum of the planes (each
  word weighted by its plane and column), so that the two checkouts'
  planes can be compared;
- with ``--strands``: ``Searcher("dna", rc=True).search`` of a 23 bp
  pattern at k=3 over ``--mib`` MiB of random ACGT, both strands, end to
  end (host clock, ended by a synchronise): twice on a writeable array
  (each search prepares both strands), with the device memory's peak
  above what it held before the first; then twice on a read-only copy
  (a checkout that keeps both strands prepares nothing the second
  time);
- with ``--overhang-search``: ``Searcher("iupac", rc=True, alpha).search``
  over ``--mib`` MiB of random ACGT, both strands, end to end (host
  clock, ended by a synchronise), ``OH_SEARCH_RUNS`` times (the first
  pays one-time costs), at ``chip_smoke.py`` phase 8's shape (a 23 bp
  pattern at k=3, alpha 0.5: the word level) and phase 9's (a 120 bp
  pattern with two IUPAC codes at k=10, alpha 0.1: the position level),
  each with copies planted in the middle (one substitution) and hanging
  off both ends, without and with ``max_n_frac`` 0.3; with the host time
  of the steps inside each search: the strands' preparation
  (``prepare_strands``), the candidates (``TorchEngine.candidates``), the
  host finish (the checkout's ``Searcher`` finish methods) and in it the
  traceback's fill and walk (``traceback._fill_batch``, ``_walk_batch``);
  the matches and a digest of the Match list;
- with ``--cli-search N``: the checkout's command line in this process,
  ``search -f barcodes.fa -k 3 -o out.tsv reads.fa`` on the card (its
  files under ``build/compare_cli/``) at ``chip_smoke.py`` phase 17b's
  shape: the 96 barcodes over N 10 kbp reads, each read with one planted
  copy as ``--plant`` makes them. After one run over the first 200 reads
  (warm-up, not reported), ``CLI_RUNS`` in turns: with the CLI's reader
  thread (``fastx.prefetch``) and with the parse in series (that call
  replaced by the iterator itself). Each run's wall (host clock from the
  CLI's start, ended by a synchronise), its batched calls
  (``Searcher._search_many_batched_async``), q2meta launches, the
  TextSet and dispatch calls' host time, the host's waits for the
  dispatch thread, the host finish (the Searcher's ``last_finish_split``
  summed), the output of its records (``cli._emit_record``), the
  dispatch thread's busy time (the functions it ran), the text sets'
  uploads (``batch._upload_set`` calls) and the seconds in the piece plan
  (``batch._plan_columns``; each "absent" where the checkout lacks the
  function) and digests of the TSV and of stderr, so that the checkouts
  can be compared; with
  ``--cli-v2`` as well, where the checkout groups the CLI's calls
  (``cli._groups``), one run with ``--v2``; with ``--cli-profile``, one
  more run with the reader thread under ``cProfile`` (every thread, on
  Python 3.12): its ``CLI_PROFILE_TOP`` functions by own time;
- with ``--no-scans``, none of the scan kernels' timings above (the
  prepared text, q1meta, q1, q2meta, q2), nor ``--overhang-reads``.

The runs go OLD, NEW, NEW, OLD for ``--turns 2`` (ABBA per turn), so a
drift of the card's clocks falls on both. Prints the card's name and
power limit, then one JSON line per run; ``--out`` also writes them there.
Inputs come from ``--seed``, the same in every run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

PATTERN_LEN = 23
BARCODE_LEN = 24
N_BARCODES = 96
READ_LEN = 10_000
#: more reads than one dispatch chunk takes (8,710 pieces of 321 words)
N_READS = 9_000
K = 3
PLANT_AT = 5_000
MUT_AT = 11
DEVICE = "cuda"
#: --off-target: guides, the genome the width is cut for, the bases made
OFF_GUIDES = 312
OFF_GENOME_BP = 3_120_000_000
OFF_CHUNK_BP = 28_000_000
#: --overhang-search: (name, alpha, k, pattern length, hang) of
#: chip_smoke.py's phases 8 and 9
OH_SEARCH = (("phase8", 0.5, 3, 23, 4), ("phase9", 0.1, 10, 120, 10))
#: searches of each: the first pays one-time costs
OH_SEARCH_RUNS = 6
#: --overhang-reads: patterns, their length, k and alpha
OH_Q = 8
OH_LEN = 120
OH_K = 10
OH_ALPHA = 0.1
#: --search-many: the timed ``search_many`` calls of a run
SEARCH_MANY_RUNS = 3
#: --cli-search: the runs after the warm-up, in turns
CLI_RUNS = ("prefetch", "serial", "serial", "prefetch")
#: reads of the warm-up run
CLI_WARM_READS = 200
#: functions of the --cli-profile run listed
CLI_PROFILE_TOP = 30


def _cuda_ms(fn, reps: int) -> float:
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


def _child(root: str, seed: int, mib: int, reps: int,
           search_reads: int, plant: bool, overhang_reads: int,
           q2_reads: int = 0, off_target: bool = False,
           pack_sets: bool = False, strands: bool = False,
           scans: bool = True, overhang_search: bool = False,
           cli_reads: int = 0, cli_v2: bool = False,
           cli_profile: bool = False) -> dict:
    """One run: the kernels of the checkout at ``root``."""
    sys.path.insert(0, root)
    import torch

    from sassy_tpu_torch import profiles
    from sassy_tpu_torch.ops import myers_cuda
    from sassy_tpu_torch.ops.myers_torch import TorchEngine

    if not Path(myers_cuda.__file__).resolve().is_relative_to(
            Path(root).resolve()):
        raise SystemExit(f"imported {myers_cuda.__file__}, not from {root}")
    myers_cuda.build()
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    bases = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)

    def acgt(n: int):
        return bases[torch.randint(0, 4, (n,), generator=gen, device=dev)]

    dna = profiles.Dna()
    out = {"root": root}
    if pack_sets:
        out.update(_pack_sets(acgt, dna, reps))
    if strands:
        out.update(_strands(acgt, dna, mib))
    if overhang_search:
        out.update(_overhang_search(acgt, mib))
    if cli_reads:
        barcodes = acgt(N_BARCODES * BARCODE_LEN).cpu().numpy()
        out.update(_cli_search(dna, barcodes.reshape(N_BARCODES, -1), acgt,
                               cli_reads, cli_v2, cli_profile))
    if not scans:
        if search_reads:
            barcodes = acgt(N_BARCODES * BARCODE_LEN).cpu().numpy()
            out.update(_search_many(dna, barcodes.reshape(N_BARCODES, -1),
                                    acgt, search_reads, plant))
        return out
    eng = TorchEngine(dev)
    text = acgt(mib << 20)
    pattern = acgt(PATTERN_LEN).cpu().numpy()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    prep = eng.prepare(dna, text)
    inp = eng.build_inputs(dna, dna.encode(pattern), prep, K)
    torch.cuda.synchronize()
    out["prepared_gib"] = (torch.cuda.memory_allocated() - before) / 2**30
    times = []
    for _ in range(reps):
        for cache in ("_wins", "_descs"):  # the parent's, this tree's
            getattr(prep, cache, {}).clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.build_inputs(dna, dna.encode(pattern), prep, K)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["build_inputs_ms"] = sum(times) / reps
    ascii_ = profiles.Ascii()
    for mode in ("pure", "iupac", "ascii"):
        prof = ascii_ if mode == "ascii" else dna
        inp = eng.build_inputs(prof, prof.encode(pattern),
                               prep if mode != "ascii"
                               else eng.prepare(ascii_, text), K)
        inp.eq_mode = mode
        args = (inp.windows, inp.tile0, inp.valid_from, inp.valid_to,
                inp.pmasks, inp.is_pad, inp.h_init, inp.m_real,
                inp.boundary_m, inp.k, inp.eq_mode)
        out[f"q1meta_{mode}_ms"] = _cuda_ms(
            lambda: myers_cuda.scan_meta(*args), reps)
    del prep, inp, args
    if hasattr(myers_cuda, "scan"):
        iupac = profiles.Iupac()
        pat = acgt(OH_LEN).cpu().numpy()
        pat[[30, 90]] = (ord("R"), ord("Y"))
        inp = eng.build_inputs(iupac, iupac.encode(pat),
                               eng.prepare(iupac, text), OH_K, OH_ALPHA)
        args = (inp.windows, inp.tile0, inp.pmasks, inp.is_pad, inp.h_init,
                inp.m_real, inp.boundary_m, inp.eq_mode)
        out["q1_shape"] = list(inp.windows.shape)
        out["q1_iupac_ms"] = _cuda_ms(lambda: myers_cuda.scan(*args), reps)
        del inp, args
    del text
    if hasattr(myers_cuda, "scan_q_meta"):
        from sassy_tpu_torch.ops.batch import BatchEngine, TextSet

        beng = BatchEngine(dev)
        barcodes = acgt(N_BARCODES * BARCODE_LEN).cpu().numpy()
        codes = [dna.encode(b) for b in barcodes.reshape(N_BARCODES, -1)]
        reads = acgt(N_READS * READ_LEN).cpu().numpy().reshape(N_READS, -1)
        ts = TextSet(list(reads), dev)
        (g,) = beng.groups(dna, codes, ts, K)
        pp = ts.piece_plan(g.halo, g.w_chars)
        q0, q1, t0, t1 = next(beng.chunks(g, pp))
        win = _chunk_windows(ts, dna, pp, t0, t1)
        out["q2meta_shape"] = [q1 - q0, pp.NW, t1 - t0]
        out["q2meta_pure_ms"] = _cuda_ms(
            lambda: beng.scan(win, g, pp, q0, q1, t0, t1, K), reps)
        del ts, win, reads
        if off_target:
            out.update(_off_target_chunk(acgt, dna, beng, reps))
        if q2_reads and hasattr(myers_cuda, "scan_q"):
            iupac = profiles.Iupac()
            pats = acgt(OH_Q * OH_LEN).cpu().numpy().reshape(OH_Q, -1)
            reads = acgt(q2_reads * READ_LEN).cpu().numpy().reshape(
                q2_reads, -1)
            ts = TextSet(list(reads), dev)
            (g,) = beng.groups(iupac, [iupac.encode(p) for p in pats], ts,
                               OH_K, OH_ALPHA)
            pp = ts.piece_plan(g.halo, g.w_chars, g.steps)
            q0, q1, t0, t1 = next(beng.chunks(g, pp))
            win = _chunk_windows(ts, iupac, pp, t0, t1)
            out["q2_shape"] = [q1 - q0, pp.NW, t1 - t0, g.eq_mode]
            out["q2_ms"] = _cuda_ms(
                lambda: beng.scan(win, g, pp, q0, q1, t0, t1, OH_K), reps)
            del ts, win, reads
        if search_reads:
            out.update(_search_many(dna, barcodes.reshape(N_BARCODES, -1),
                                    acgt, search_reads, plant))
    if overhang_reads and hasattr(myers_cuda, "scan_q"):
        out.update(_overhang_dispatch(acgt, overhang_reads))
    return out


def _off_target_chunk(acgt, dna, beng, reps: int) -> dict:
    """q2meta on one full dispatch chunk at off_targets_full's shape
    (``chip_smoke.py`` phase 5's ``off_targets_chunk``)."""
    from sassy_tpu_torch.ops.batch import TextSet, _piece_width

    guides = acgt(OFF_GUIDES * PATTERN_LEN).cpu().numpy()
    guides = [dna.encode(g) for g in guides.reshape(OFF_GUIDES, -1)]
    ts = TextSet([acgt(OFF_CHUNK_BP).cpu().numpy()], "cuda")
    (g,) = beng.groups(dna, guides, ts, K)
    g.w_chars = _piece_width([OFF_GENOME_BP], 0, g.halo, g.Q, g.pair_bytes)
    pp = ts.piece_plan(g.halo, g.w_chars)
    q0, q1, t0, t1 = next(beng.chunks(g, pp))
    win = _chunk_windows(ts, dna, pp, t0, t1)
    return {"q2meta_off_shape": [q1 - q0, pp.NW, t1 - t0],
            "q2meta_off_ms": _cuda_ms(
                lambda: beng.scan(win, g, pp, q0, q1, t0, t1, K), reps)}


#: --pack-set's sets: (label, texts, bytes a text)
PACK_SETS = (("one text", 1, OFF_GENOME_BP),
             ("nanopore_full", 33_400, READ_LEN),
             ("pattern_scaling 50 bp", 33_554_432 // 50, 50))


def _pack_sets(acgt, dna, reps: int) -> dict:
    """The text set's pack kernel on ``PACK_SETS``, both strands."""
    import torch

    from sassy_tpu_torch import diagnostics
    from sassy_tpu_torch.ops import batch

    out = {}
    for label, texts, n in PACK_SETS:
        data = torch.empty(texts * n, dtype=torch.uint8, device=DEVICE)
        for c0 in range(0, data.numel(), 1 << 28):
            c1 = min(data.numel(), c0 + (1 << 28))
            data[c0:c1] = acgt(c1 - c0)
        words = -(-n // 32)
        i64 = dict(dtype=torch.int64, device=DEVICE)
        starts = torch.arange(texts, **i64) * n
        lens = torch.full((texts,), n, **i64)
        wofs = torch.arange(texts + 1, **i64) * words
        width = -(-(texts * words + 1) // 4) * 4
        nbytes = (data.numel() + 4 * dna.planes * width
                  + 8 * (3 * texts + 1))
        rec = {"texts": texts, "bytes": data.numel(), "width": width,
               "bound_ms": nbytes / diagnostics.MEM_BYTES_PER_S * 1e3}
        for reverse in (False, True):
            args = (data, starts, lens, wofs, width, dna, reverse)
            planes = batch.pack_set(*args).to(torch.int64)
            weight = (torch.arange(planes.shape[1], device=DEVICE) % 1009
                      + 1) * 4
            rec[f"{'reverse' if reverse else 'forward'}_sum"] = int(sum(
                (row * (weight + p)).sum() for p, row in enumerate(planes)))
            del planes
            rec[f"{'reverse' if reverse else 'forward'}_ms"] = _cuda_ms(
                lambda: batch.pack_set(*args), reps)
        out[f"pack_set {label}"] = rec
        del data, starts, lens, wofs
        torch.cuda.empty_cache()
    return out


def _strands(acgt, dna, mib: int) -> dict:
    """Two-strand single-engine searches over ``mib`` MiB, on a writeable
    array and on a read-only copy."""
    import time

    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher

    text = acgt(mib << 20).cpu().numpy()
    pattern = acgt(PATTERN_LEN).cpu().numpy()
    searcher = Searcher("dna", rc=True, device=DEVICE)
    out = {"strands_writeable_s": [], "strands_read_only_s": []}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for key, src in (("strands_writeable_s", text),
                     ("strands_writeable_s", text),
                     ("strands_read_only_s", None),
                     ("strands_read_only_s", None)):
        if src is None:
            src = out.setdefault("_frozen", np.frombuffer(text.tobytes(),
                                                          np.uint8))
        t0 = time.perf_counter()
        matches = searcher.search(pattern, src, K)
        torch.cuda.synchronize()
        out[key].append(time.perf_counter() - t0)
        if "strands_peak_gib" not in out:
            out["strands_peak_gib"] = (torch.cuda.max_memory_allocated()
                                       - before) / 2**30
    out["strands_matches"] = len(matches)
    del out["_frozen"]
    return out


def _overhang_search(acgt, mib: int) -> dict:
    """Two-strand single-engine searches with overhang at phases 8's and
    9's shapes over ``mib`` MiB, with the traceback's fill and walk
    timed."""
    import time

    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher, profiles, traceback
    from sassy_tpu_torch.ops.myers_torch import TorchEngine

    iupac = profiles.Iupac()
    steps = (
        (traceback, "_fill_batch", "fill"), (traceback, "_walk_batch", "walk"),
        (TorchEngine, "prepare_strands", "prepare"),
        (TorchEngine, "candidates", "candidates"),
        # the host finish: the parent's per-cell steps, or the arrays'
        (Searcher, "_postprocess", "finish"), (Searcher, "_to_forward",
                                               "finish"),
        (Searcher, "_finish_strand", "finish"), (Searcher, "_matches",
                                                 "finish"))
    acc = dict.fromkeys([key for _, _, key in steps], 0.0)
    wrapped = []
    for owner, name, key in steps:
        fn = getattr(owner, name, None)
        if fn is None:
            continue
        wrapped.append((owner, name, fn))

        def timed(*a, _fn=fn, _key=key, **kw):
            t0 = time.perf_counter()
            res = _fn(*a, **kw)
            acc[_key] += time.perf_counter() - t0
            return res
        setattr(owner, name, timed)
    out = {}
    try:
        for name, alpha, k, m, hang in OH_SEARCH:
            text = acgt(mib << 20).cpu().numpy()
            planted = acgt(m).cpu().numpy()
            pattern = planted.copy()
            if m > 90:  # two IUPAC codes, as phase 9's pattern
                pattern[[30, 90]] = [ord("R"), ord("Y")]
                planted[30] = ord("A") if planted[30] in b"CT" else planted[30]
                planted[90] = ord("C") if planted[90] in b"AG" else planted[90]
            n = len(text)
            mutated = planted.copy()
            mutated[MUT_AT] = ord("A") if mutated[MUT_AT] != ord("A") \
                else ord("C")
            text[n // 5 : n // 5 + m] = mutated
            text[: m - hang] = planted[hang:]
            text[n - (m - hang):] = planted[: m - hang]
            # the N filter (max_n_frac) reads the text around each match
            for tag, nfrac in (("", None), ("_nfrac", 0.3)):
                searcher = Searcher("iupac", rc=True, alpha=alpha,
                                    max_n_frac=nfrac, device=DEVICE)
                times = {}
                for _ in range(OH_SEARCH_RUNS):
                    acc.update(dict.fromkeys(acc, 0.0))
                    t0 = time.perf_counter()
                    matches = searcher.search(pattern, text, k)
                    torch.cuda.synchronize()
                    times.setdefault("search", []).append(
                        time.perf_counter() - t0)
                    for key, v in acc.items():
                        times.setdefault(key, []).append(v)
                for key, v in times.items():
                    out[f"{name}{tag}_{key}_s"] = v
                out[f"{name}{tag}_matches"] = len(matches)
                out[f"{name}{tag}_matches_digest"] = hashlib.sha256(
                    "".join(f"{mt.sort_key()} {mt.cigar.to_string()}\n"
                            for mt in matches).encode()).hexdigest()[:16]
            del text
    finally:
        for owner, name, fn in wrapped:
            setattr(owner, name, fn)
    return out


def _chunk_windows(ts, prof, pp, t0, t1):
    """A dispatch chunk's windows as the checkout's engine hands them to
    the kernel: the descriptor where it has one, else the window
    tensor."""
    if hasattr(ts, "descriptor"):
        return ts.descriptor(prof, pp, False, t0, t1)
    return ts.windows(prof, pp, False, t0, t1)


def _overhang_dispatch(acgt, n_reads: int) -> dict:
    import time

    import torch

    from sassy_tpu_torch import profiles
    from sassy_tpu_torch.ops import batch, myers_cuda

    iupac = profiles.Iupac()
    reads = list(acgt(n_reads * READ_LEN).cpu().numpy().reshape(n_reads, -1))
    pats = acgt(OH_Q * OH_LEN).cpu().numpy().reshape(OH_Q, -1)
    pcodes = [iupac.encode(p) for p in pats]
    out = {"overhang_reads": n_reads}
    for run in ("cold", "warm"):
        acc = {"windows": 0.0, "descriptor": 0.0, "scan": 0.0,
               "select": 0.0}
        calls = dict.fromkeys(acc, 0)
        eng = batch.BatchEngine(DEVICE)
        ts = batch.TextSet(reads, DEVICE)
        (g,) = eng.groups(iupac, pcodes, ts, OH_K, OH_ALPHA)
        pp = ts.piece_plan(g.halo, g.w_chars, g.steps)
        ts.planes(iupac, False, g.steps)

        def timed(obj, name):
            fn = getattr(obj, name)

            def wrapper(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn(*a, **kw)
                torch.cuda.synchronize()
                acc[name] += time.perf_counter() - t0
                calls[name] += 1
                return res
            setattr(obj, name, wrapper)

        for obj, name in ((ts, "windows"), (ts, "descriptor"),
                          (eng, "scan"), (eng, "select")):
            if hasattr(obj, name):
                timed(obj, name)
        myers_cuda.scan_q.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        found = eng.dispatch(iupac, ts, g, OH_K, False, False)
        n = sum(int(c.shape[1]) for c in found)
        out[f"overhang_{run}"] = {
            "dispatch_ms": (time.perf_counter() - t0) * 1e3,
            **{f"{k}_ms": v * 1e3 for k, v in acc.items()},
            "calls": calls, "q2_launches": myers_cuda.scan_q.launches,
            "pieces": pp.T, "NW": pp.NW, "candidates": n}
        del eng, ts, found
    return out


def _reads(dna, barcodes, acgt, n_reads: int, plant: bool):
    """N random reads of READ_LEN (n_reads, READ_LEN) uint8, with
    ``plant`` each with one copy of a barcode (see ``--plant``)."""
    import numpy as np

    reads = acgt(n_reads * READ_LEN).cpu().numpy().reshape(n_reads, -1)
    if plant:
        mutated = barcodes.copy()
        col = mutated[:, MUT_AT]
        mutated[:, MUT_AT] = np.where(col != ord("A"), ord("A"), ord("C"))
        rc = np.frombuffer(
            b"".join(dna.reverse_complement(m) for m in mutated), np.uint8
        ).reshape(mutated.shape)
        i = np.arange(n_reads)
        site = slice(PLANT_AT, PLANT_AT + barcodes.shape[1])
        reads[0::2, site] = mutated[i[0::2] % len(barcodes)]
        reads[1::2, site] = rc[i[1::2] % len(barcodes)]
    return reads


def _cli_search(dna, barcodes, acgt, n_reads: int, v2: bool,
                profile: bool) -> dict:
    """``--cli-search``: the checkout's CLI search, timed and split."""
    import contextlib
    import cProfile
    import io
    import pstats

    import torch

    from sassy_tpu_torch import cli, search
    from sassy_tpu_torch.io import fastx
    from sassy_tpu_torch.ops import batch, myers_cuda

    d = Path(__file__).resolve().parents[2] / "build" / "compare_cli"
    d.mkdir(parents=True, exist_ok=True)
    reads = _reads(dna, barcodes, acgt, n_reads, True)
    fa, warm, bc, tsv = (d / n for n in ("reads.fa", "warm.fa",
                                         "barcodes.fa", "out.tsv"))
    for path, rows in ((fa, reads), (warm, reads[:CLI_WARM_READS])):
        path.write_bytes(b"".join(b">read%d\n" % i + r.tobytes() + b"\n"
                                  for i, r in enumerate(rows)))
    bc.write_bytes(b"".join(b">bc%d\n" % q + b.tobytes() + b"\n"
                            for q, b in enumerate(barcodes)))
    acc: dict = {}

    def wrap(owner, name, make):
        setattr(owner, name, make(getattr(owner, name)))

    def timed(key, on_result=None):
        def make(fn):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                got = fn(*a, **kw)
                acc[key] += time.perf_counter() - t0
                return on_result(got) if on_result else got
            return wrapper
        return make

    def counted_as(key):
        def make(fn):
            def wrapper(*a, **kw):
                acc[key] += 1
                return fn(*a, **kw)
            return wrapper
        return make

    counted = counted_as("calls")

    def finished(fn):
        def wrapper(self, *a, **kw):
            try:
                return fn(self, *a, **kw)
            finally:
                for key, v in self.last_finish_split.items():
                    if key in ("filters", "gather", "fill", "walk", "build"):
                        acc["finish"] += v
        return wrapper

    # the text sets' uploads and the piece plan, where the checkout has them
    has = {name: hasattr(batch, name)
           for name in ("_upload_set", "_plan_columns")}
    if has["_upload_set"]:
        wrap(batch, "_upload_set", counted_as("uploads"))
    if has["_plan_columns"]:
        wrap(batch, "_plan_columns", timed("plan"))
    wrap(batch.TextSet, "__init__", timed("dispatch"))
    wrap(batch.BatchEngine, "candidates_many_async",
         timed("dispatch", timed("wait")))
    wrap(search.Searcher, "_search_many_batched_async", counted)
    wrap(search.Searcher, "_finish_many_batched", finished)
    wrap(cli, "_emit_record", timed("emit"))

    def on_thread(fn):  # the dispatch thread's busy time
        def wrapper(device, job):
            return fn(device, timed("thread")(job))
        return wrapper

    wrap(batch, "dispatch_async", on_thread)
    prefetch = fastx.prefetch

    def run(name, reads_fa, extra=(), prof=None):
        fastx.prefetch = (prefetch if name != "serial"
                          else lambda it, depth=2: iter(it))
        acc.update(dict.fromkeys(("dispatch", "wait", "finish", "emit",
                                   "thread", "plan"), 0.0), calls=0,
                   uploads=0)
        myers_cuda.scan_q_meta.launches = 0
        err = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (contextlib.redirect_stderr(err), prof
              or contextlib.nullcontext()):
            code = cli.main(["--device", DEVICE, "search", "-f", str(bc),
                             "-k", str(K), *extra, "-o", str(tsv),
                             str(reads_fa)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        body = tsv.read_bytes()
        return {"run": name, "rc": code, "wall_s": wall,
                "calls": acc["calls"],
                "q2meta": myers_cuda.scan_q_meta.launches,
                "dispatch_s": acc["dispatch"], "wait_s": acc["wait"],
                "finish_s": acc["finish"], "emit_s": acc["emit"],
                "dispatch_thread_s": acc["thread"],
                "set_uploads": (acc["uploads"] if has["_upload_set"]
                                else "absent"),
                "plan_s": acc["plan"] if has["_plan_columns"] else "absent",
                "rows": body.count(b"\n") - 1,
                "tsv_digest": hashlib.sha256(body).hexdigest()[:16],
                "stderr_digest": hashlib.sha256(
                    err.getvalue().encode()).hexdigest()[:16]}

    run("warm-up", warm)
    runs = [run(name, fa) for name in CLI_RUNS]
    if v2 and hasattr(cli, "_groups"):
        runs.append(run("v2", fa, ["--v2"]))
    out = {"cli_reads": n_reads, "cli_runs": runs}
    if profile:
        prof = cProfile.Profile()
        runs.append(run("profiled", fa, prof=prof))
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(
            CLI_PROFILE_TOP)
        out["cli_profile"] = text.getvalue().splitlines()
    fastx.prefetch = prefetch
    return out


def _search_many(dna, barcodes, acgt, n_reads: int, plant: bool) -> dict:
    import time
    import tracemalloc

    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher
    from sassy_tpu_torch.ops.batch import BatchEngine, TextSet

    reads = list(_reads(dna, barcodes, acgt, n_reads, plant))
    pcodes = [dna.encode(b) for b in barcodes]
    ccodes = [dna.encode(np.frombuffer(dna.complement(b), np.uint8))
              for b in barcodes]
    out = {"search_reads": n_reads, "planted": plant, "async_return_ms": [],
           "both_finish_ms": []}
    for _ in ("first", "second"):
        eng = BatchEngine("cuda")
        ts = TextSet(reads, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin = eng.candidates_many_async(dna, pcodes, ts, K)
        rfin = eng.candidates_many_async(dna, ccodes, ts, K, reverse=True)
        t1 = time.perf_counter()
        fin()
        rfin()
        t2 = time.perf_counter()
        out["async_return_ms"].append((t1 - t0) * 1e3)
        out["both_finish_ms"].append((t2 - t0) * 1e3)
        del eng, ts, fin, rfin
    # the text set's preparation alone: both strands' planes of a fresh
    # set (host clock), its upload apart where the checkout has
    # ``TextSet.data``, then the host memory a second one allocates
    out["prep_ms"] = []
    split = hasattr(TextSet, "data")
    out["upload_ms"] = [] if split else "absent"
    out["upload_gbs"] = [] if split else "absent"
    out["pack_ms"] = [] if split else "absent"
    n_bytes = sum(len(r) for r in reads)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts = TextSet(reads, "cuda")
        if split:
            tc = time.perf_counter()
            ts.data()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        ts.planes(dna, False)
        ts.planes(dna, True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out["prep_ms"].append((t2 - t0) * 1e3)
        if split:
            out["upload_ms"].append((t1 - tc) * 1e3)
            out["upload_gbs"].append(n_bytes / (t1 - tc) / 1e9)
            out["pack_ms"].append((t2 - t1) * 1e3)
        del ts
    tracemalloc.start()
    try:
        ts = TextSet(reads, "cuda")
        ts.planes(dna, False)
        ts.planes(dna, True)
        torch.cuda.synchronize()
        out["prep_host_peak_mib"] = tracemalloc.get_traced_memory()[1] / 2**20
    finally:
        tracemalloc.stop()
    del ts
    searcher = Searcher("dna", rc=True, device="cuda")
    out["search_many_s"] = []
    for _ in range(SEARCH_MANY_RUNS):
        t0 = time.perf_counter()
        matches = searcher.search_many(list(barcodes), reads, K)
        out["search_many_s"].append(time.perf_counter() - t0)
    out["matches"] = len(matches)
    # where the checkout has it
    out["finish_split"] = getattr(searcher, "last_finish_split", {})
    out["matches_digest"] = hashlib.sha256("".join(
        f"{m.sort_key()} {m.cigar.to_string()}\n" for m in matches
    ).encode()).hexdigest()[:16]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--mib", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--search-many", type=int, default=0, metavar="N_READS")
    ap.add_argument("--plant", action="store_true")
    ap.add_argument("--overhang-reads", type=int, default=0, metavar="N")
    ap.add_argument("--q2-reads", type=int, default=0, metavar="N")
    ap.add_argument("--off-target", action="store_true")
    ap.add_argument("--pack-set", action="store_true")
    ap.add_argument("--strands", action="store_true")
    ap.add_argument("--overhang-search", action="store_true")
    ap.add_argument("--no-scans", action="store_true")
    ap.add_argument("--cli-search", type=int, default=0, metavar="N_READS")
    ap.add_argument("--cli-v2", action="store_true")
    ap.add_argument("--cli-profile", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        print(json.dumps(_child(a.child, a.seed, a.mib, a.reps,
                                a.search_many, a.plant, a.overhang_reads,
                                a.q2_reads, a.off_target, a.pack_set,
                                a.strands, not a.no_scans,
                                a.overhang_search, a.cli_search,
                                a.cli_v2, a.cli_profile)),
              flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    lines = [card]
    order = []
    for turn in range(a.turns):
        order += [a.old, a.new] if turn % 2 == 0 else [a.new, a.old]
    for root in order:
        proc = subprocess.run(
            [sys.executable, __file__, a.old, a.new, "--child",
             str(Path(root).resolve()), "--seed", str(a.seed), "--mib",
             str(a.mib), "--reps", str(a.reps), "--search-many",
             str(a.search_many), "--overhang-reads", str(a.overhang_reads),
             "--q2-reads", str(a.q2_reads)]
            + (["--plant"] if a.plant else [])
            + (["--off-target"] if a.off_target else [])
            + (["--pack-set"] if a.pack_set else [])
            + (["--strands"] if a.strands else [])
            + (["--overhang-search"] if a.overhang_search else [])
            + (["--no-scans"] if a.no_scans else [])
            + ["--cli-search", str(a.cli_search)]
            + (["--cli-v2"] if a.cli_v2 else [])
            + (["--cli-profile"] if a.cli_profile else []),
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise SystemExit(f"run of {root} failed:\n{proc.stderr}")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        lines.append(line)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
