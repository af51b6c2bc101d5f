"""One-shot small-search latency: the time to the first match set.

    python -m sassy_tpu_torch.tools.bench_oneshot [--reps 20]
        [--device cuda|cpu]

The port of the reference's ``scripts/bench_oneshot.py:35-71``: what the
CLI's first query sees, one ``Searcher.search`` (forward strand, a 23 bp
random pattern, k=3) over a fresh text array at each call, so no prepared
text or window is reused; the process is warm (the kernels built, the
allocator grown) after three searches of throwaway texts of the same
size. For each n in ``SIZES``: the median, p10 and p90 of ``--reps``
calls, and n over the median. Every text holds the pattern at n/2, and each search must
find it at cost 0. The reference's ``--no-fast`` switched off a fused path
(``ONE_SHOT_BYTES_MAX``) that the port does not have. Prints the card's
name and power limit, one line per size and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .timing import open_device, spread

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
SIZES = (10_000, 100_000, 1_000_000)
M, K = 23, 3
SEED = 3  # the reference script's


def run(reps: int = 20, device="cuda", log=print) -> dict:
    from .. import Searcher, profiles

    rng = np.random.default_rng(SEED)
    pat = rng.choice(BASES, size=M)
    s = Searcher(profiles.Iupac(), rc=False, device=device)
    rows = []
    log(f"{'n':>10} {'median':>9} {'p10':>9} {'p90':>9} {'GB/s':>7}  "
        "(one-shot Searcher.search, fresh text each call)")
    for n in SIZES:
        for _ in range(3):
            s.search(pat, rng.choice(BASES, size=n), K)
        times = []
        for r in range(reps):
            text = rng.choice(BASES, size=n)
            text[n // 2 : n // 2 + M] = pat
            t0 = time.perf_counter()
            got = s.search(pat, text, K)
            times.append(time.perf_counter() - t0)
            if not any(m.cost == 0 for m in got):
                raise AssertionError(f"n={n} rep {r}: the planted copy "
                                     "was not found")
        sp = spread(times)
        rows.append({"n": n, **{f"{k}_ms": v * 1e3 for k, v in sp.items()},
                     "gbps": n / sp["median"] / 1e9})
        log(f"{n:>10} {sp['median'] * 1e3:8.2f}m {sp['p10'] * 1e3:8.2f}m "
            f"{sp['p90'] * 1e3:8.2f}m {n / sp['median'] / 1e9:7.3f}")
    return {"tool": "bench_oneshot", "device": str(device), "m": M, "k": K,
            "reps": reps, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev, card = open_device("bench_oneshot", a.device)
    if dev is None:
        return 2
    rec = run(a.reps, dev, log=lambda msg: print(msg, flush=True))
    if card:
        rec["card"] = card
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
