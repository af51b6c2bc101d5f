"""Check an off-target bench's candidates against its planted sites.

    python -m sassy_tpu_torch.tools.planted_sites [--device cuda]

Makes the genome and guides of the ``off_targets_full`` bench exactly as
``sassy_tpu_torch.evals.bench_suite`` does (same seeds, same bytes): a
guide copy with up to k substitutions every ``plant_every`` bp, guide
``i % num_queries`` at the i-th site. Runs the batched engine once over
it (all guides in one call, and guide 0 alone, as the bench's ``tiling``
and ``search`` columns do), and checks that every planted site comes back
as a candidate of its guide ending at the copy's end (within k positions:
a substituted last base may move the minimum), positions past 2^31
included (the genome of ``off_targets_full`` is 3.12 Gbp). Prints the
card's name and power limit, the sites and candidates counted on each
side of 2^31, the call's time, and the peak device memory; exits 1 if a
site is missing.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from ..evals import bench_suite
from ..ops.batch import BatchEngine, TextSet
from ..profiles import Iupac

POS31 = 1 << 31


def card() -> str:
    if not torch.cuda.is_available():
        return "host (no CUDA device)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()


BENCH = "off_targets_full"


def run(device: str) -> int:
    """The check; returns the number of planted sites missing."""
    cfg = bench_suite.load_config(BENCH)
    m, k = cfg["query_len"], cfg["k"]
    t0 = time.perf_counter()
    queries, text = bench_suite.off_target_data(cfg, 1.0)
    num_q, n = len(queries), len(text)
    print(f"{BENCH}: {num_q} guides x {n} bp made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    every = cfg["plant_every"]
    sites = np.arange(every, n - m, every, dtype=np.int64)
    sites = sites[sites + m < n]
    site_q = np.arange(len(sites)) % num_q
    ends = sites + m

    prof = Iupac()
    eng = BatchEngine(device)
    ts = TextSet([text], eng.device)
    qcodes = [prof.encode(q) for q in queries]
    missing = 0
    for label, pats in (("all guides", range(num_q)), ("guide 0", [0])):
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
            torch.cuda.reset_peak_memory_stats(eng.device)
        t0 = time.perf_counter()
        q, _, pos, cost = eng.candidates_many_flat(
            prof, [qcodes[i] for i in pats], ts, k)
        wall = time.perf_counter() - t0
        q = np.asarray(pats)[q]
        want = np.isin(site_q, pats)
        got = set(zip(q.tolist(), pos.tolist()))
        # a substitution at the copy's last base may move its minimum by
        # up to k positions
        found = np.array([any((int(a), int(b) + d) in got
                              for d in range(-k, k + 1))
                          for a, b in zip(site_q[want], ends[want])], bool)
        hi = ends[want] > POS31
        peak = (f"{torch.cuda.max_memory_allocated(eng.device) / 2**30:.3f}"
                " GiB" if eng.device.type == "cuda" else "not measured")
        print(f"{label}: {len(q)} candidates ({int((pos > POS31).sum())} "
              f"past 2^31) in {wall:.3f} s; planted sites found "
              f"{int(found[~hi].sum())}/{int((~hi).sum())} below 2^31, "
              f"{int(found[hi].sum())}/{int(hi.sum())} past it; costs "
              f"{np.bincount(cost, minlength=k + 1).tolist()}; peak device "
              f"memory {peak}", flush=True)
        for a, b in list(zip(site_q[want][~found], ends[want][~found]))[:10]:
            print(f"  missing: guide {a} ending at {b}")
        missing += int((~found).sum())
    return missing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sassy_tpu_torch.tools.planted_sites",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    print(card(), flush=True)
    return 1 if run(args.device) else 0


if __name__ == "__main__":
    sys.exit(main())
