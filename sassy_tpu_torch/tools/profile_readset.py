"""The batched engine on a read set against one flat text of the same
bytes.

    python -m sassy_tpu_torch.tools.profile_readset [--q 96] [--mb 334]
        [--read-len 10000] [--plant-every 5000] [--device cuda|cpu]

The port of the reference's ``scripts/profile_readset.py:31-89``: ``--q``
random 24 bp patterns at k=3 over ``--mb`` million random bases, a copy of
pattern i mod Q with 0-3 substitutions every ``--plant-every`` bases, cut
into reads of ``--read-len`` (the nanopore_full shape by default) and
searched as the reads and as one flat text, each a ``TextSet`` made once.
For each: ``BatchEngine.candidates_many`` end to end, the best of 3 after
one warm call, its match count, the aggregate rate (Q x bytes over the
time), and the time ``candidates_many_async`` takes to return (the
dispatch then runs on the engine's thread). Prints the card's name and
power limit, one line each and one JSON line.
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
SEED = 0  # the reference script's


def best_of(fn, reps: int = 3) -> float:
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def make_inputs(Q: int, mb: float, read_len: int, plant_every: int):
    """(patterns, flat text, reads) as the reference script makes them."""
    total = int(mb * 1_000_000)
    rng = np.random.default_rng(SEED)
    pats = [rng.choice(BASES, size=M) for _ in range(Q)]
    flat = rng.choice(BASES, size=total)
    pos, qi = plant_every, 0
    while pos + M < total:
        q = pats[qi % Q].copy()
        for _ in range(rng.integers(0, K + 1)):
            q[rng.integers(0, M)] = rng.choice(BASES)
        flat[pos : pos + M] = q
        pos += plant_every
        qi += 1
    n_reads = total // read_len
    reads = [flat[i * read_len : (i + 1) * read_len] for i in range(n_reads)]
    return pats, flat, reads


def run(Q: int = 96, mb: float = 334, read_len: int = 10_000,
        plant_every: int = 5000, device="cuda", log=print) -> dict:
    from ..ops.batch import BatchEngine, TextSet
    from ..profiles import Iupac

    pats, flat, reads = make_inputs(Q, mb, read_len, plant_every)
    prof = Iupac()
    codes = [prof.encode(p) for p in pats]
    eng = BatchEngine(device)
    rows = {}
    for label, texts in (("reads", reads), ("flat", [flat])):
        ts = TextSet(texts, eng.device)
        t_full = best_of(lambda: eng.candidates_many(prof, codes, ts, K))
        out = eng.candidates_many(prof, codes, ts, K)
        nm = sum(len(c) for row in out for c in row)
        t0 = time.perf_counter()
        fin = eng.candidates_many_async(prof, codes, ts, K)
        t_issue = time.perf_counter() - t0
        fin()
        agg = Q * len(flat) / 1e9
        rows[label] = {"texts": len(texts), "e2e_ms": t_full * 1e3,
                       "agg_gbps": agg / t_full, "matches": nm,
                       "issue_ms": t_issue * 1e3}
        log(f"{label:5s}: end-to-end {t_full * 1e3:7.1f} ms "
            f"({agg / t_full:5.1f} GB/s agg, {nm} matches); "
            f"dispatch-issue {t_issue * 1e3:6.1f} ms")
    return {"tool": "profile_readset", "device": str(device), "Q": Q,
            "n": len(flat), "read_len": read_len, "k": K,
            "reads_over_flat": (rows["reads"]["e2e_ms"]
                                / rows["flat"]["e2e_ms"]),
            **rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--q", type=int, default=96)
    ap.add_argument("--mb", type=float, default=334)
    ap.add_argument("--read-len", type=int, default=10_000)
    ap.add_argument("--plant-every", type=int, default=5000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev, card = open_device("profile_readset", a.device)
    if dev is None:
        return 2
    rec = run(a.q, a.mb, a.read_len, a.plant_every, dev, log=lambda msg: print(msg, flush=True))
    if card:
        rec["card"] = card
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
