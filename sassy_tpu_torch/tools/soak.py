"""Differential soak of the port's engines against the numpy oracle.

    python -m sassy_tpu_torch.tools.soak [--pairs 1000000] [--seed 0]
        [--workers N] [--device cuda|cpu] [--log FILE]
    python -m sassy_tpu_torch.tools.soak --repro GROUP SEED
    python -m sassy_tpu_torch.tools.soak --single [--pairs 3000] [--seed 0]
    python -m sassy_tpu_torch.tools.soak --single --repro CASE SEED
    python -m sassy_tpu_torch.tools.soak --trace [--pairs 80000] [--seed 0]

The port of the reference's ``scripts/soak_batch.py`` (batch mode, the
default) and ``scripts/soak_cpu.py`` (``--single``). The reference's
load-bearing conformance contract is a 1,000,000-case differential fuzz
between its engines; here every (pattern, text) pair the port's engines
answer on ``--device`` is held to ``oracle.candidates``, the direct DP.

Batch mode: each *group* is one shape signature of ``SIGNATURES`` (Q
patterns x T texts of n chars, fixed k / alpha / all_minima / reverse),
made by ``gen_group`` from ``numpy.random.default_rng((seed, group))``
byte for byte as the reference script makes it, and answered by one
``BatchEngine(device).candidates_many`` call (a ``TextSet`` with
``reverse=True`` where the signature says so: positions then come back in
reversed-text coordinates, and the oracle reads the reversed text). Two
spot pairs of each group also go through ``TorchEngine(device)``, where
the reference spot-checks its XLA engine. Signatures run round-robin: the
reference's 14, then two of 110 bp at k=10, alpha 0.1 (101 overshoot
steps, more than the word-level path's three words), so a round of 16
groups (8,000 pairs) also reaches the position-level kernels: q2 in the
batch, q1 in the spot pairs.

``--trace`` (batch mode) also holds Match records and CIGARs: each group
goes through ``Searcher(profile, rc=reverse, alpha).search_many_with_fn``
on ``--device`` (the filters, the traceback kernel reading the strands'
planes, the Match build), once with the Iupac profile and, where the
signature has no overhang, once with the Ascii one (forward only);
``TRACE_SAMPLE`` of its matches, drawn from ``default_rng((seed, group,
1))``, and every match of the two spot pairs through
``Searcher.search_with_fn`` (the single engine) are each held to the
scalar traceback, ``traceback.trace_candidate`` over ``oracle.dp_matrix``,
at the match's end in its strand (the complemented pattern on the
reversed text for RC): cost, coordinates and CIGAR. The spot pairs'
matches must also end, strand by strand, where ``oracle.candidates``
puts the candidates. On the card a traced run also needs the traceback
kernel launched.

``--single`` mode: ``gen_case`` from ``default_rng(seed)``, one case at a
time as the reference script makes it, each through ``TorchEngine``,
``BatchEngine`` and, for every second case, ``BatchEngine`` with
``reverse=True``. The pattern is encoded for both sides (the reference
script hands its raw bytes to both engines as codes).

The oracle runs in a pool of ``--workers`` processes (default: one fewer
than the host's cores; 0 runs it in this process) while this process
drives the device; every group or case is made here, so neither a result
nor a repro line depends on the pool. On the first mismatch the tool
prints the pair and a repro line and exits 1; ``--repro`` writes that
group's (or case's) patterns and texts to ``build/soak/``.

At the end: the card's name and power limit, the pairs and pairs/s, the
seconds split into the device side and the oracle's, the kernels' launch
counts (in batch mode on the card, a run of at least one round fails
unless q1meta, q2meta, q1 and q2 each launched; ``--single`` needs q1meta
and q2meta), and one JSON line. A passing run on the card appends its
line to ``--log`` (default ``evals/output-h100/soak_log.txt``; a run on
the CPU logs only where ``--log`` is given). Progress every 8 groups (100
cases).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np

from .. import oracle, profiles
from ..matchrec import Strand
from ..ops import myers_cuda
from ..traceback import trace_candidate
from .timing import launch_counts, open_device

ROOT = Path(__file__).resolve().parents[2]
LOG = ROOT / "evals" / "output-h100" / "soak_log.txt"
REPRO_DIR = ROOT / "build" / "soak"

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
IUPAC = np.frombuffer(b"ACGTNRYSWKM", dtype=np.uint8)

#: (Q, T, n, m, k, alpha, all_minima, reverse): scripts/soak_batch.py's
#: 14, then two that reach the position-level kernels
SIGNATURES = [
    (16, 48, 2048, 12, 2, None, False, False),
    (16, 48, 2048, 12, 2, None, True, False),
    (16, 48, 2048, 23, 3, None, False, True),
    (8, 64, 4096, 23, 3, None, False, False),
    (8, 64, 4096, 23, 3, 0.5, False, False),
    (16, 48, 2048, 7, 1, None, False, False),
    (16, 48, 2048, 7, 0, 0.0, True, False),
    (8, 48, 2048, 18, 4, 1.0, False, False),
    (8, 48, 2048, 18, 4, 0.25, True, True),
    (4, 64, 4096, 48, 5, None, False, False),
    (4, 48, 2048, 100, 6, None, True, False),
    (16, 48, 1024, 5, 2, None, False, True),
    (8, 48, 2048, 23, 0, None, False, False),
    (8, 48, 2048, 23, 3, 0.5, True, False),
    (4, 48, 4096, 110, 10, 0.1, False, False),
    (4, 48, 4096, 110, 10, 0.1, True, True),
]
#: groups between progress lines; cases per unit of --single
PROGRESS_GROUPS = 8
SINGLE_UNIT = 100
#: units (groups, or SINGLE_UNIT cases) whose oracle work is in flight
DEPTH = 2
KERNELS = ("q1meta", "q2meta", "q1", "q2")
#: --trace: the matches of each group (and profile) held to the scalar
#: traceback, besides every match of its spot pairs
TRACE_SAMPLE = 32


def gen_text(rng, n, mode):
    if mode == 0:  # uniform
        return rng.choice(BASES, size=n)
    if mode == 1:  # homopolymer plateau segments
        segs, tot = [], 0
        while tot < n:
            r = int(rng.integers(10, 300))
            segs.append(np.full(r, rng.choice(BASES), np.uint8))
            tot += r
        return np.concatenate(segs)[:n]
    # uniform with N runs
    t = rng.choice(BASES, size=n)
    for _ in range(int(rng.integers(0, 4))):
        p = int(rng.integers(0, max(1, n - 10)))
        t[p : p + int(rng.integers(1, 10))] = ord("N")
    return t


def gen_group(rng, sig):
    """One group's patterns and texts for a signature
    (``scripts/soak_batch.py:97-114``)."""
    Q, T, n, m, k, alpha, allm, reverse = sig
    pats = [
        rng.choice(IUPAC if rng.random() < 0.2 else BASES, size=m)
        for _ in range(Q)
    ]
    texts = []
    for _ in range(T):
        tmode = int(rng.integers(0, 3))
        text = gen_text(rng, n, tmode)
        # plant mutated copies of random patterns, half targeted at
        # power-of-two boundaries (tile-edge multiples)
        for _ in range(int(rng.integers(0, 4))):
            pat = pats[int(rng.integers(0, Q))]
            mut = pat.copy()
            for _ in range(int(rng.integers(0, k + 1))):
                mut[int(rng.integers(0, m))] = rng.choice(BASES)
            if rng.random() < 0.5:
                p = int(rng.integers(0, n - m + 1))
            else:
                b = int(rng.choice([256, 512, 1024, 2048]))
                p = max(0, min(n - m, b - int(rng.integers(0, m + 2))))
            text[p : p + m] = mut
        texts.append(text)
    return pats, texts


def gen_case(rng):
    """One case of ``scripts/soak_cpu.py:51-71``."""
    m = int(rng.integers(2, 24))
    n = int(rng.integers(m, 4000))
    tmode = int(rng.integers(0, 3))
    text = gen_text(rng, n, tmode)
    pat = rng.choice(IUPAC if rng.random() < 0.2 else BASES, size=m)
    for _ in range(int(rng.integers(0, 4))):
        if rng.random() < 0.5:
            p = int(rng.integers(0, n - m + 1))
        else:
            b = int(rng.choice([256, 512, 1024, 2048]))
            p = max(0, min(n - m, b - int(rng.integers(0, m + 2))))
        text[p : p + m] = pat
    k = int(rng.integers(0, min(m, 6)))
    alpha = (
        float(rng.choice([0.0, 0.5, 1.0])) if rng.random() < 0.25 else None
    )
    allm = bool(rng.integers(0, 2))
    return m, n, tmode, text, pat, k, alpha, allm


def group(seed: int, gidx: int):
    """(signature, patterns, texts, spot pairs) of group ``gidx``."""
    sig = SIGNATURES[gidx % len(SIGNATURES)]
    rng = np.random.default_rng((seed, gidx))
    pats, texts = gen_group(rng, sig)
    spot = [(int(rng.integers(0, sig[0])), int(rng.integers(0, sig[1])))
            for _ in range(2)]
    return sig, pats, texts, spot


def repro_case(case_no: int, seed: int):
    rng = np.random.default_rng(seed)
    for _ in range(case_no + 1):
        got = gen_case(rng)
    return got


def _oracle(pairs):
    """Worker side: ``oracle.candidates`` of each (pattern codes, text, k,
    alpha, all_minima); returns (lists, seconds)."""
    t0 = time.perf_counter()
    prof = profiles.Iupac()
    out = [oracle.candidates(prof, p, t, k, a, None, allm)
           for p, t, k, a, allm in pairs]
    return out, time.perf_counter() - t0


class _Unit(NamedTuple):
    """One group (or SINGLE_UNIT cases): the oracle's pairs, each pair's
    label and the group or case that regenerates it, and ``card()``, the
    device's answers in the same order."""

    name: str
    labels: list
    pairs: list
    card: Callable[[], list]


def group_unit(seed: int, gidx: int, prof, be, te) -> _Unit:
    from ..ops.batch import TextSet

    sig, pats, texts, spot = group(seed, gidx)
    Q, T, n, m, k, alpha, allm, reverse = sig
    pcodes = [prof.encode(p) for p in pats]
    otexts = ([np.ascontiguousarray(t[::-1]) for t in texts] if reverse
              else texts)
    labels = [(f"pair=(q={qi}, t={ti})", gidx)
              for qi in range(Q) for ti in range(T)]
    pairs = [(pcodes[qi], otexts[ti], k, alpha, allm)
             for qi in range(Q) for ti in range(T)]
    labels += [(f"spot pair=(q={qi}, t={ti}) on TorchEngine", gidx)
               for qi, ti in spot]
    pairs += [(pcodes[qi], texts[ti], k, alpha, allm) for qi, ti in spot]

    def card():
        if reverse:
            got = be.candidates_many(prof, pcodes, TextSet(texts, be.device),
                                     k, alpha, None, allm, reverse=True)
        else:
            got = be.candidates_many(prof, pcodes, texts, k, alpha, None,
                                     allm)
        out = [got[qi][ti] for qi in range(Q) for ti in range(T)]
        out += [te.candidates(prof, pcodes[qi], texts[ti], k, alpha, None,
                              allm) for qi, ti in spot]
        return out

    return _Unit(f"group={gidx} seed={seed} sig={sig}", labels, pairs, card)


def case_unit(rng, seed: int, c0: int, c1: int, prof, be, te) -> _Unit:
    from ..ops.batch import TextSet

    labels, pairs, calls = [], [], []
    for case in range(c0, c1):
        m, n, tmode, text, pat, k, alpha, allm = gen_case(rng)
        pcode = prof.encode(pat)
        what = (f"case={case} seed={seed} m={m} n={n} k={k} alpha={alpha} "
                f"allm={allm} tmode={tmode}")
        for engine in ("TorchEngine", "BatchEngine"):
            labels.append((f"{engine} {what}", case))
            pairs.append((pcode, text, k, alpha, allm))
        calls.append(("torch", pcode, text, k, alpha, allm))
        calls.append(("batch", pcode, text, k, alpha, allm))
        if case % 2 == 0:
            labels.append((f"BatchEngine reverse {what}", case))
            pairs.append((pcode, np.ascontiguousarray(text[::-1]), k, alpha,
                          allm))
            calls.append(("reverse", pcode, text, k, alpha, allm))

    def card():
        out = []
        for how, pcode, text, k, alpha, allm in calls:
            if how == "torch":
                out.append(te.candidates(prof, pcode, text, k, alpha, None,
                                         allm))
            else:
                texts = (TextSet([text], be.device) if how == "reverse"
                         else [text])
                out.append(be.candidates_many(
                    prof, [pcode], texts, k, alpha, None, allm,
                    reverse=how == "reverse")[0][0])
        return out

    return _Unit(f"cases {c0}..{c1 - 1} seed={seed}", labels, pairs, card)


def _in_strand(prof, pat, text, strand):
    """A pattern and a text as the search of ``strand`` reads them: the
    complemented pattern on the reversed text for RC."""
    if strand is Strand.RC:
        return (np.frombuffer(prof.complement(pat), np.uint8),
                np.ascontiguousarray(text[::-1]))
    return pat, text


def _scalar(prof, pats, texts, k: int, alpha, mt):
    """``mt`` (a Match of pattern ``pats[mt.pattern_idx]`` over text
    ``texts[mt.text_idx]``) and the scalar traceback at its end, each as
    (cost, start and end in the strand, pattern start and end, CIGAR)."""
    n = len(texts[mt.text_idx])
    pat, text = _in_strand(prof, pats[mt.pattern_idx], texts[mt.text_idx],
                           mt.strand)
    start, end = mt.text_start, mt.text_end
    if mt.strand is Strand.RC:
        start, end = n - end, n - start
    got = (mt.cost, start, end, mt.pattern_start, mt.pattern_end,
           mt.cigar.to_string())
    w = trace_candidate(prof, pat, prof.encode(pat), text,
                        end + len(pat) - mt.pattern_end, len(pat) + k,
                        alpha, None)
    return got, (w.cost, w.text_start, w.text_end, w.pattern_start,
                 w.pattern_end, w.cigar.to_string())


def trace_group(seed: int, gidx: int, device) -> tuple[str | None, int]:
    """--trace: group ``gidx``'s matches through the ``Searcher`` on
    ``device``, a sample and the spot pairs' held to the scalar
    traceback. Returns (the first difference or None, matches held)."""
    from ..search import Searcher

    sig, pats, texts, spot = group(seed, gidx)
    Q, T, n, m, k, alpha, allm, reverse = sig
    rng = np.random.default_rng((seed, gidx, 1))
    held = 0
    for prof in [profiles.Iupac()] + ([profiles.Ascii()] if alpha is None
                                      else []):
        s = Searcher(prof, rc=reverse and prof.name != "ascii", alpha=alpha,
                     device=device)
        got = s.search_many_with_fn(pats, texts, k, allm, None)
        pick = rng.choice(len(got), min(TRACE_SAMPLE, len(got)),
                          replace=False)
        held_now = [(f"{prof.name} search_many match {i}", got[i])
                    for i in np.sort(pick).tolist()]
        for qi, ti in spot:
            cell = s.search_with_fn(pats[qi], texts[ti], k, allm, None)
            what = f"{prof.name} spot pair=(q={qi}, t={ti})"
            for strand in (Strand.FWD, Strand.RC) if s.rc else (Strand.FWD,):
                pat, text = _in_strand(prof, pats[qi], texts[ti], strand)
                want = [e for e, _ in oracle.candidates(
                    prof, prof.encode(pat), text, k, alpha, None, allm)]
                ends = sorted((n - mt.text_start if strand is Strand.RC
                               else mt.text_end) + m - mt.pattern_end
                              for mt in cell if mt.strand is strand)
                if ends != want:
                    return (f"{what} {strand.name}: match ends {ends} != "
                            f"the oracle's candidates {want}"), held
            for mt in cell:
                mt.pattern_idx, mt.text_idx = qi, ti
                held_now.append((what, mt))
        for what, mt in held_now:
            a, b = _scalar(prof, pats, texts, k, alpha, mt)
            if a != b:
                return (f"{what}: {mt!r} gives {a}, the scalar traceback "
                        f"{b}"), held
            held += 1
    return None, held


def run(pairs: int, seed: int, device, workers: int, single: bool = False,
        log=print, trace: bool = False) -> dict:
    """Soak ``pairs`` pairs (``single``: cases, each counted as one pair;
    ``trace``: each group's matches held as well, see ``trace_group``).
    Returns the record: ``ok``, and on a mismatch its ``mismatch`` and
    ``repro`` lines."""
    from ..ops.batch import BatchEngine
    from ..ops.myers_torch import TorchEngine

    prof = profiles.Iupac()
    be, te = BatchEngine(device), TorchEngine(device)
    # a worker that dies breaks the pool and raises here: it never hangs
    pool = (ProcessPoolExecutor(workers, multiprocessing.get_context("spawn"))
            if workers > 0 else None)
    before = launch_counts()
    traces_before = myers_cuda.trace_windows.launches
    card_s = oracle_s = wait_s = trace_s = 0.0
    done = units = traced = 0
    rng = np.random.default_rng(seed)
    pending: deque = deque()
    t0 = time.perf_counter()

    def check(unit, got, job):
        nonlocal oracle_s, wait_s
        tw = time.perf_counter()
        if pool is None:
            want, sec = _oracle(unit.pairs)
        else:
            parts = [f.result() for f in job]
            want = [w for lists, _ in parts for w in lists]
            sec = sum(s for _, s in parts)
        wait_s += time.perf_counter() - tw
        oracle_s += sec
        for (label, idx), g, w in zip(unit.labels, got, want):
            if sorted(map(tuple, g)) != sorted(map(tuple, w)):
                mode = "--single --repro" if single else "--repro"
                return (f"MISMATCH {unit.name} {label}",
                        f"repro: python -m sassy_tpu_torch.tools.soak {mode} "
                        f"{idx} {seed}")
        return None

    bad = None
    try:
        while done < pairs or pending:
            if done < pairs:
                if single:
                    c1 = min(pairs, done + SINGLE_UNIT)
                    unit = case_unit(rng, seed, done, c1, prof, be, te)
                    n_unit = c1 - done
                else:
                    unit = group_unit(seed, units, prof, be, te)
                    n_unit = len(unit.pairs) - 2
                job = None if pool is None else [
                    pool.submit(_oracle, unit.pairs[i : i + 16])
                    for i in range(0, len(unit.pairs), 16)]
                tc = time.perf_counter()
                got = unit.card()
                card_s += time.perf_counter() - tc
                if trace:
                    tc = time.perf_counter()
                    diff, held = trace_group(seed, units, device)
                    trace_s += time.perf_counter() - tc
                    traced += held
                    if diff is not None:
                        bad = (f"MISMATCH {unit.name} traced {diff}",
                               f"repro: python -m sassy_tpu_torch.tools.soak "
                               f"--repro {units} {seed}")
                        break
                pending.append((unit, got, job))
                done += n_unit
                units += 1
                if units % (1 if single else PROGRESS_GROUPS) == 0:
                    dt = time.perf_counter() - t0
                    log(f"{done}/{pairs} {'cases' if single else 'pairs'} "
                        f"run ({dt:.0f}s, {done / max(dt, 1e-9):.0f}/s)")
            if len(pending) > DEPTH or (done >= pairs and pending):
                unit, got, job = pending.popleft()
                bad = check(unit, got, job)
                if bad is not None:
                    break
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    rec = {"tool": "soak", "mode": "single" if single else "batch",
           "ok": bad is None, "seed": seed, "device": str(device),
           "workers": workers, "pairs": done, "wall_s": wall,
           "pairs_per_s": done / max(wall, 1e-9), "card_s": card_s,
           "oracle_s": oracle_s, "oracle_wait_s": wait_s,
           "launches": launched}
    if not single:
        rec["signatures"] = len(SIGNATURES)
    if trace:
        rec.update(traced=traced, trace_s=trace_s,
                   trace_launches=(myers_cuda.trace_windows.launches
                                   - traces_before))
    if bad is not None:
        rec["mismatch"], rec["repro"] = bad
    return rec


def required(rec: dict) -> tuple:
    """Kernels a passing run on the card must have launched."""
    if rec["mode"] == "single":
        return ("q1meta", "q2meta")
    one_round = sum(sig[0] * sig[1] for sig in SIGNATURES)
    return KERNELS if rec["pairs"] >= one_round else ()


def write_repro(gidx: int, seed: int, single: bool) -> Path:
    REPRO_DIR.mkdir(parents=True, exist_ok=True)
    if single:
        m, n, tmode, text, pat, k, alpha, allm = repro_case(gidx, seed)
        out = REPRO_DIR / f"case_{gidx}_seed{seed}.npz"
        np.savez(out, text=text, pat=pat)
        print(f"m={m} n={n} k={k} alpha={alpha} allm={allm} tmode={tmode} "
              f"pat={bytes(pat)} -> {out}")
        return out
    sig, pats, texts, _ = group(seed, gidx)
    out = REPRO_DIR / f"group_{gidx}_seed{seed}.npz"
    np.savez(out, *pats, *texts)
    print(f"group {gidx} sig={sig} -> {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int,
                    help="pairs to soak (default 1,000,000; --single: "
                         "cases, default 3000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repro", nargs=2, type=int, metavar=("GROUP", "SEED"),
                    help="write one group's (--single: case's) inputs to "
                         "build/soak/ and stop")
    ap.add_argument("--single", action="store_true",
                    help="scripts/soak_cpu.py's one-case-at-a-time soak")
    ap.add_argument("--trace", action="store_true",
                    help="also hold each group's Match records and CIGARs "
                         "to the scalar traceback (batch mode)")
    ap.add_argument("--workers", type=int,
                    default=max(0, (os.cpu_count() or 1) - 1),
                    help="oracle processes (0: in this process)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log", help="append the passing run's line here "
                    "(default on the card: evals/output-h100/soak_log.txt)")
    a = ap.parse_args(argv)
    if a.trace and a.single:
        ap.error("--trace holds the groups of batch mode, not --single")
    if a.repro:
        write_repro(a.repro[0], a.repro[1], a.single)
        return 0
    dev, card = open_device("soak", a.device)
    if dev is None:
        return 2
    pairs = a.pairs if a.pairs is not None else (3000 if a.single
                                                else 1_000_000)
    rec = run(pairs, a.seed, dev, a.workers, a.single,
              log=lambda msg: print(msg, flush=True), trace=a.trace)
    if not rec["ok"]:
        print(f"{rec['mismatch']}  {rec['repro']}", flush=True)
        return 1
    if card:
        rec["card"] = card
    n, what = rec["pairs"], "cases" if a.single else "pairs"
    msg = (f"SOAK PASSED: {n} {what} in {rec['wall_s']:.1f}s "
           f"({rec['pairs_per_s']:.0f} {what}/s; device "
           f"{rec['card_s']:.1f}s, oracle {rec['oracle_s']:.1f}s in "
           f"{a.workers} workers, {rec['oracle_wait_s']:.1f}s waited; "
           + (f"{len(SIGNATURES)} signatures, " if not a.single else "")
           + (f"{rec['traced']} matches held to the scalar traceback in "
              f"{rec['trace_s']:.1f}s, {rec['trace_launches']} traceback "
              "kernel launches, " if a.trace else "")
           + f"seed={a.seed}, {dev}; launches {rec['launches']})")
    print(msg, flush=True)
    missing = [k for k in required(rec) if dev.type == "cuda"
               and rec["launches"][k] == 0]
    if a.trace and dev.type == "cuda" and not rec["trace_launches"]:
        missing.append("the traceback kernel")
    if missing:
        print(f"soak: {', '.join(missing)} never launched", flush=True)
        return 1
    print(json.dumps(rec), flush=True)
    log = Path(a.log) if a.log else (LOG if dev.type == "cuda" else None)
    if log is not None:
        log.parent.mkdir(parents=True, exist_ok=True)
        with open(log, "a") as fh:
            fh.write(time.strftime("%Y-%m-%d %H:%M:%S ") + msg
                     + (f" [{card}]" if card else "") + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
