"""Traceback-heavy workload: the host traceback's share of a search.

    python -m sassy_tpu_torch.tools.bench_traceback [--matches 10000]
        [--mb 64] [--device cuda|cpu]

The port of the reference's ``scripts/bench_traceback.py:28-75``:
``Searcher.search_all`` (candidates and the CIGAR traceback of every
match) against ``without_trace().search_all`` (candidates only) on a
match-dense text, ``--mb`` million random bases with ``--matches``
evenly spaced copies of a 24 bp pattern carrying 0-3 substitutions, k=3,
forward strand. Each path is warmed on the first MiB; the traced search
runs twice (the first full-size call reported apart). Both must return the
same number of matches. Prints the card's name and power limit, the
times, the ratio with its criterion (< 10x, the reference's) and one JSON
line; exits 1 when the ratio misses the criterion, as the reference does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .timing import open_device

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
M, K = 24, 3
CRITERION = 10.0
SEED = 7  # the reference script's


def make_inputs(n_matches: int, text_mb: float):
    """(pattern bytes, text bytes) as the reference script makes them."""
    n = int(text_mb * 1e6)
    rng = np.random.default_rng(SEED)
    pat = rng.choice(BASES, size=M)
    text = rng.choice(BASES, size=n)
    step = n // (n_matches + 1)
    for i in range(n_matches):
        mut = pat.copy()
        for _ in range(int(rng.integers(0, K + 1))):
            mut[int(rng.integers(0, M))] = rng.choice(BASES)
        off = (i + 1) * step
        text[off : off + M] = mut
    return bytes(pat), bytes(text)


def run(n_matches: int = 10_000, text_mb: float = 64.0, device="cuda",
        log=print):
    """Measure; returns (record, the traced search's matches)."""
    from .. import Searcher, profiles

    pattern, text = make_inputs(n_matches, text_mb)
    s = Searcher(profiles.Iupac(), rc=False, device=device)
    s.search_all(pattern, text[: 1 << 20], K)
    t0 = time.perf_counter()
    s.search_all(pattern, text, K)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    matches = s.search_all(pattern, text, K)
    t_all = time.perf_counter() - t0

    s2 = Searcher(profiles.Iupac(), rc=False, device=device).without_trace()
    s2.search_all(pattern, text[: 1 << 20], K)
    t0 = time.perf_counter()
    ends = s2.search_all(pattern, text, K)
    t_scan = time.perf_counter() - t0
    if len(matches) != len(ends):
        raise AssertionError(f"{len(matches)} traced matches against "
                             f"{len(ends)} untraced")
    ratio = t_all / t_scan if t_scan > 0 else float("inf")
    log(f"matches={len(matches)} text={text_mb:g} MB m={M} k={K}\n"
        f"scan-only (trace=False): {t_scan * 1e3:8.1f} ms\n"
        f"search_all (with trace): {t_all * 1e3:8.1f} ms  "
        f"(first {t_first * 1e3:.1f})\n"
        f"trace overhead ratio:    {ratio:8.2f}x  (criterion: < "
        f"{CRITERION:g}x)")
    rec = {"tool": "bench_traceback", "device": str(device),
           "matches": len(matches), "planted": n_matches, "n": len(text),
           "m": M, "k": K, "scan_ms": t_scan * 1e3, "search_all_ms":
           t_all * 1e3, "first_ms": t_first * 1e3, "ratio": ratio,
           "criterion": CRITERION, "ok": ratio < CRITERION}
    return rec, matches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--matches", type=int, default=10_000)
    ap.add_argument("--mb", type=float, default=64.0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev, card = open_device("bench_traceback", a.device)
    if dev is None:
        return 2
    rec, _ = run(a.matches, a.mb, dev, log=lambda msg: print(msg, flush=True))
    if card:
        rec["card"] = card
    print(json.dumps(rec))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
