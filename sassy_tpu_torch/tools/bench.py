"""The headline on one GPU: single-pattern text-scan throughput.

    python -m sassy_tpu_torch.tools.bench [--n 1073741824] [--seed 42]
        [--device cuda|cpu]

The shape of the reference's ``bench.py`` (``bench.py:83-172``): 1 GiB of
random ACGT made on the card from ``--seed`` (a deployment keeps the
genome resident in device memory, so the upload is not timed), a 23 bp
random pattern with one substitution planted at 12345, n/2 and n - 5000,
k=3. ``TorchEngine.prepare`` packs the text once; one warm ``candidates``
call, then:

- sequential: 20 calls of ``candidates`` (each ends with the host copy of
  its candidates), their median, p10, p90 and best;
- pipelined: 3 batches of 8 depth-2 ``candidates_async`` calls (the next
  dispatched before the last is finished), the time per call of each
  batch, and their median and spread;
- q1meta's own time: CUDA events around 5 batches of 10 launches of the
  scan kernel on the same windows (``TorchEngine.build_inputs``, as
  ``tools/profile_path.py`` builds them), one warm-up launch first.

Every list must hold the planted ends, and every list must equal the warm
call's. Prints the card's name and power limit, one line per measure, and
one JSON line with ``bench.py``'s keys (``value`` is the better of the
sequential and the pipelined median rates, ``vs_baseline`` against the
reference Rust's 2.105 GB/s on one thread) and the spreads. There is no
CPU fallback and no retry at a smaller size: without a card and without
``--device cpu`` the tool exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .timing import batch_ms, open_device, spread

BASELINE_GBPS = 2.105  # reference sassy1, 23bp/k=3, 1 thread AVX-512
PATTERN_LEN = 23
K = 3
MUT_AT = 11
#: q1meta timing: batches of launches, launches per batch
KERNEL_BATCHES = 5
KERNEL_REPS = 10


def make_inputs(n: int, seed: int, device):
    """(text on ``device``, pattern, planted ends): ``n`` random ACGT
    bytes from a ``torch.Generator`` seeded with ``seed``, the pattern from
    ``numpy.random.default_rng(seed)``, and its copy with base 11 moved to
    the next of ACGT planted at 12345, n/2 and n - 5000 (as ``bench.py``)."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pattern = rng.choice(bases, size=PATTERN_LEN)
    planted = pattern.copy()
    planted[MUT_AT] = bases[(np.where(bases == planted[MUT_AT])[0][0] + 1) % 4]
    gen = torch.Generator(device=dev).manual_seed(seed)
    tbases = torch.from_numpy(bases.copy()).to(dev)
    text = torch.empty(n, dtype=torch.uint8, device=dev)
    for c0 in range(0, n, 1 << 28):
        c1 = min(n, c0 + (1 << 28))
        text[c0:c1] = tbases[torch.randint(0, 4, (c1 - c0,), generator=gen,
                                           device=dev)]
    ends = []
    for off in (12345, n // 2, n - 5000):
        text[off : off + PATTERN_LEN] = torch.from_numpy(planted).to(dev)
        ends.append(off + PATTERN_LEN)
    return text, pattern, ends


def run(n: int = 1 << 30, seed: int = 42, device="cuda", seq: int = 20,
        batches: int = 3, calls: int = 8, log=print):
    """Measure; returns (record, the warm call's candidates). Raises
    ``AssertionError`` when a list lacks a planted end or differs."""
    from ..ops import myers_cuda
    from ..ops.myers_torch import TorchEngine
    from ..profiles import Iupac

    dev = torch.device(device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        myers_cuda.build()  # nvcc at first use, else the library built before
    t_build = time.perf_counter() - t0
    text, pattern, ends = make_inputs(n, seed, dev)
    prof = Iupac()
    pcodes = prof.encode(pattern)
    eng = TorchEngine(dev)

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    prep = eng.prepare(prof, text)
    if on_card:
        torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0

    def call():
        return eng.candidates(prof, pcodes, prep, K, None, None, False)

    def start():
        return eng.candidates_async(prof, pcodes, prep, K, None, None, False)

    t0 = time.perf_counter()
    cands = call()
    warm = time.perf_counter() - t0
    found = {e for e, _ in cands}
    if not set(ends) <= found:
        raise AssertionError(f"planted ends {ends} not all among "
                             f"{cands[:10]}")
    log(f"n={n} kernels' library {t_build:.1f} s, prepare {t_prep:.3f} s, "
        f"warm candidates {warm:.3f} s "
        f"({len(cands)} candidates)")

    seq_s = []
    for _ in range(seq):
        t0 = time.perf_counter()
        got = call()
        seq_s.append(time.perf_counter() - t0)
        if got != cands:
            raise AssertionError("a sequential candidates list differs")

    pipe_s, pending, t_return = [], None, None
    for _ in range(batches):
        results = []
        t0 = time.perf_counter()
        prev = start()
        if pending is None:
            t_return = time.perf_counter() - t0
            # finish() is the dispatch's Future.result: not done yet here
            pending = not prev.__self__.done()
        for _ in range(calls - 1):
            nxt = start()
            results.append(prev())
            prev = nxt
        results.append(prev())
        pipe_s.append((time.perf_counter() - t0) / calls)
        if any(r != cands for r in results):
            raise AssertionError("a pipelined candidates list differs from "
                                 "the sequential one")

    inp = eng.build_inputs(prof, pcodes, prep, K)
    kernel = batch_ms(lambda: eng.scan(inp), dev, KERNEL_REPS, KERNEL_BATCHES)

    s_seq, s_pipe, s_kern = spread(seq_s), spread(pipe_s), spread(kernel)
    seq_gbps = n / s_seq["median"] / 1e9
    pipe_gbps = n / s_pipe["median"] / 1e9
    gbps = max(seq_gbps, pipe_gbps)

    def ms(sp):
        return {f"{k}_ms": v * 1e3 for k, v in sp.items()}

    rec = {
        "metric": "text_scan_23bp_k3",
        "value": gbps,
        "unit": "GB/s",
        "vs_baseline": gbps / BASELINE_GBPS,
        "backend": dev.type,
        "sequential_gbps": seq_gbps,
        "pipelined_gbps": pipe_gbps,
        "n": n,
        "sequential": {"calls": seq, **ms(s_seq),
                       "best_gbps": n / s_seq["best"] / 1e9,
                       "p10_gbps": n / s_seq["p90"] / 1e9,
                       "p90_gbps": n / s_seq["p10"] / 1e9},
        "pipelined": {"batches": batches, "calls": calls, **ms(s_pipe),
                      "batch_ms": [t * 1e3 for t in pipe_s]},
        "q1meta_ms": {"batches": KERNEL_BATCHES, "launches": KERNEL_REPS,
                      **{f"{k}_ms": v for k, v in s_kern.items()}},
        "build_s": t_build,
        "prepare_s": t_prep,
        "warm_s": warm,
        "candidates": len(cands),
        "async_return_ms": t_return * 1e3,
        "async_pending": pending,
        # q1meta launches: the candidates calls, then the timed ones
        "calls": 1 + seq + batches * calls,
        "kernel_launches": 1 + KERNEL_BATCHES * KERNEL_REPS,
    }
    log(f"sequential: median {s_seq['median'] * 1e3:.3f} ms "
        f"(p10 {s_seq['p10'] * 1e3:.3f}, p90 {s_seq['p90'] * 1e3:.3f}, "
        f"best {s_seq['best'] * 1e3:.3f}) of {seq} = {seq_gbps:.2f} GB/s")
    log(f"pipelined (depth 2, {batches} x {calls}): median "
        f"{s_pipe['median'] * 1e3:.3f} ms per call (batches "
        + ", ".join(f"{t * 1e3:.3f}" for t in pipe_s)
        + f") = {pipe_gbps:.2f} GB/s; candidates_async returned in "
        f"{t_return * 1e3:.3f} ms, pending={pending}")
    what = "q1meta" if on_card else "q1meta's plain version"
    log(f"{what}: median {s_kern['median']:.3f} ms (p10 {s_kern['p10']:.3f}, "
        f"p90 {s_kern['p90']:.3f}, best {s_kern['best']:.3f}) per launch, "
        f"{KERNEL_BATCHES} x {KERNEL_REPS}")
    return rec, cands


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 30, help="text bytes")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev, card = open_device("bench", a.device)
    if dev is None:
        return 2
    rec, _ = run(a.n, a.seed, dev, log=lambda msg: print(msg, flush=True))
    if card:
        rec["card"] = card
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
