"""Times of the sharded search on one card: the fast path and the
overhang path, at one text shard and at four.

    python -m sassy_tpu_torch.tools.bench_sharded [--mb 1024] [--reps 5]

The shape is ``scripts/bench_sharded_alpha.py``'s: 4 random 20 bp patterns,
each planted once, at k=2 over ``--mb`` million random bases made on the
card from ``--seed``; one pattern group, ``Dt`` = 1 and 4 text shards on
the one card. For each (Dt, path) it runs one warm-up search and then
``--reps`` searches over the same ``ShardedText`` (its packed planes
memoised, as the reference's script reuses them), each ended by a
synchronise, and keeps the best: the fast path (alpha None: q2meta, the
cross-shard chain, word-level selection) and the overhang path (alpha
0.5: q2, position-level selection). The searches alternate between an
untimed ``ShardedSearch`` (``best_ms``) and a ``timed`` one, which reads
CUDA events at its steps' ends (``timed_best_ms``, and its best search's
``steps_ms`` from ``last_times``). The lists of
every case must equal the Dt = 1 fast / overhang lists. Prints the
card's name and power limit, one line per case, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..tools.timing import card_line, launch_counts

M, K, Q = 20, 2, 4


def run(mb: float, reps: int, device: str, seed: int) -> dict:
    from ..parallel import ShardedSearch, ShardedText, make_mesh
    from ..profiles import Iupac

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bases = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    n = int(mb * 1_000_000)
    text = torch.empty(n, dtype=torch.uint8, device=dev)
    for c0 in range(0, n, 1 << 28):
        c1 = min(n, c0 + (1 << 28))
        text[c0:c1] = bases[torch.randint(0, 4, (c1 - c0,), generator=gen,
                                          device=dev)]
    pats = bases[torch.randint(0, 4, (Q, M), generator=gen, device=dev)]
    for i in range(Q):
        text[1000 + 100 * i : 1000 + 100 * i + M] = pats[i]
    pats = list(pats.cpu().numpy())
    prof = Iupac()
    st = ShardedText(prof, text)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cases, first_lists = [], {}
    for Dt in (1, 4):
        for path, alpha in (("fast", None), ("overhang", 0.5)):
            mesh = make_mesh(Dt, 1, device=dev)
            ss = ShardedSearch(mesh=mesh)
            timed = ShardedSearch(mesh=mesh, timed=True)
            before = launch_counts()
            t0 = time.perf_counter()
            got = ss.candidates_batch(prof, pats, st, K, alpha=alpha)
            sync()
            first = time.perf_counter() - t0
            best, best_timed, steps = float("inf"), float("inf"), {}
            for _ in range(reps):
                for search in (ss, timed):
                    t0 = time.perf_counter()
                    again = search.candidates_batch(prof, pats, st, K,
                                                    alpha=alpha)
                    sync()
                    dt = time.perf_counter() - t0
                    if search is ss:
                        best = min(best, dt)
                    elif dt < best_timed:
                        best_timed, steps = dt, dict(search.last_times)
                    if again != got:
                        raise AssertionError(f"Dt={Dt} {path}: a repeat "
                                             "differs")
            want = first_lists.setdefault(path, got)
            if got != want:
                raise AssertionError(f"Dt={Dt} {path}: lists differ from "
                                     "Dt=1's")
            launched = {k: v - before[k] for k, v in launch_counts().items()}
            case = {"Dt": Dt, "path": path, "alpha": alpha,
                    "first_ms": first * 1e3, "best_ms": best * 1e3,
                    "timed_best_ms": best_timed * 1e3,
                    "text_gb_per_s": n / best / 1e9,
                    "candidates": sum(len(c) for c in got),
                    "steps_ms": {k: v * 1e3 for k, v in steps.items()},
                    "launches": launched}
            cases.append(case)
            split = ", ".join(f"{k} {v:.1f}" for k, v in
                              case["steps_ms"].items())
            print(f"Dt={Dt} {path:8s}: first {case['first_ms']:9.1f} ms, "
                  f"best of {reps} {case['best_ms']:9.1f} ms = "
                  f"{case['text_gb_per_s']:6.2f} GB/s of text; timed "
                  f"{case['timed_best_ms']:9.1f} ms "
                  f"({case['candidates']} candidates; {split} ms; "
                  f"launches {launched})", flush=True)
    best = {(c["Dt"], c["path"]): c["best_ms"] for c in cases}
    return {"bench": "sharded", "n": n, "Q": Q, "m": M, "k": K,
            "reps": reps, "device": str(dev), "cases": cases,
            "overhang_over_fast": {str(Dt): best[Dt, "overhang"]
                                   / best[Dt, "fast"] for Dt in (1, 4)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=float, default=1024,
                    help="million bases of text (default 1024)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("bench_sharded: no CUDA device", file=sys.stderr)
            return 2
        print(card_line(), flush=True)
    out = run(args.mb, args.reps, args.device, args.seed)
    if torch.device(args.device).type == "cuda":
        out["card"] = card_line()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
