"""Time the routes that fill a pinned staging buffer from many texts.

    python -m sassy_tpu_torch.tools.bench_fill [--reps 9] [--out FILE]

A pinned buffer of ``myers_torch.STAGE_BYTES`` (64 MiB) is filled on the
host from two text sets made from ``--seed``, each a list of rows of one
array of random ACGT: 64 MiB of nanopore_full's reads (10 kbp) and 8 MiB
of pattern_scaling's 50 bp texts. The routes:

- ``concatenate``: one ``np.concatenate`` into the buffer, on one thread;
- ``fill``: ``myers_torch._fill``, the staged upload's route
  (``csrc/stage_fill.cc``: one thread per intra-op thread of PyTorch, each
  an equal share of the bytes, the interpreter lock let go meanwhile);
- ``assign``: as many Python threads, each a numpy slice assignment a
  text over a contiguous range of texts;
- ``torch_copy``: the same threads, each a ``copy_`` from
  ``torch.from_numpy`` a text.

For each route and set: the host-clock ms of one fill (median and range
of ``--reps``, after one warm-up) and its GB/s; then, for ``CONTEND_S``
seconds, the fill in a loop on another thread (as the dispatch thread
fills while the caller finishes) beside a Python counter on the main
thread: the fills' GB/s in that window (completed fills only) and the
counter's rate over its rate alone (the share of the interpreter lock the
fill leaves to others). Prints the card's name and power limit, then one
JSON line; ``--out`` also writes both there. A pinned buffer needs the
card: without one the tool fails.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..ops import myers_torch

#: (name, text length, bytes) of the sets
SETS = (("nanopore_10kbp", 10_000, 64 << 20),
        ("pattern_scaling_50bp", 50, 8 << 20))
#: seconds the main thread's counter runs alone, and beside the fills
IDLE_S = 0.2
CONTEND_S = 1.0


def _ranges(lens: np.ndarray, n_threads: int) -> list[tuple[int, int]]:
    """Contiguous ranges of texts, about equal in bytes, one a thread."""
    offs = np.concatenate([[0], np.cumsum(lens)])
    cuts = np.searchsorted(offs, np.linspace(0, offs[-1], n_threads + 1))
    cuts[-1] = len(lens)
    return [(int(a), int(b)) for a, b in zip(cuts[:-1], cuts[1:]) if b > a]


def _routes(texts, buf: torch.Tensor, pool: ThreadPoolExecutor) -> dict:
    lens = np.fromiter(map(len, texts), np.int64, len(texts))
    offs = np.concatenate([[0], np.cumsum(lens)])
    n = int(offs[-1])
    view = buf.numpy()
    ranges = _ranges(lens, torch.get_num_threads())

    def threaded(each):
        for job in [pool.submit(each, a, b) for a, b in ranges]:
            job.result()

    def assign(a, b):
        for i in range(a, b):
            view[offs[i] : offs[i + 1]] = texts[i]

    def torch_copy(a, b):
        for i in range(a, b):
            buf[offs[i] : offs[i + 1]].copy_(torch.from_numpy(texts[i]))

    return {
        "concatenate": lambda: np.concatenate(texts, out=view[:n]),
        "fill": lambda: myers_torch._fill(texts, offs, 0, n, view[:n]),
        "assign": lambda: threaded(assign),
        "torch_copy": lambda: threaded(torch_copy),
    }


def _spin(stop: threading.Event) -> float:
    """Counts a second of a Python loop on this thread until ``stop`` is
    set."""
    count, t0 = 0, time.perf_counter()
    while True:
        count += 1
        if count % 1024 == 0 and stop.is_set():
            return count / (time.perf_counter() - t0)


def _contended(fill, nbytes: int, idle: float) -> dict:
    """``fill`` in a loop on another thread for ``CONTEND_S`` seconds
    beside the counter on this one: the fills' GB/s in the window and the
    counter's rate over ``idle``."""
    stop, done = threading.Event(), []
    timer = threading.Timer(CONTEND_S, stop.set)

    def run():
        while not stop.is_set():
            fill()
            done.append(time.perf_counter())

    t0 = time.perf_counter()
    th = threading.Thread(target=run)
    th.start()
    timer.start()
    rate = _spin(stop)
    th.join()
    fills = sum(t <= t0 + CONTEND_S for t in done)
    return {"gbs": fills * nbytes / CONTEND_S / 1e9,
            "left_to_others": rate / idle}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    buf = torch.empty(myers_torch.STAGE_BYTES, dtype=torch.uint8,
                      pin_memory=True)
    rng = np.random.default_rng(a.seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pool = ThreadPoolExecutor(torch.get_num_threads())
    stop = threading.Event()
    threading.Timer(IDLE_S, stop.set).start()
    idle = _spin(stop)
    out = {"card": card, "threads": torch.get_num_threads(),
           "idle_spins_per_s": idle, "sets": {}}
    for name, length, nbytes in SETS:
        rows = rng.choice(bases, (nbytes // length, length))
        texts = list(rows)
        want = rows.reshape(-1)
        got = {}
        for route, fill in _routes(texts, buf, pool).items():
            fill()
            if not np.array_equal(buf.numpy()[: want.size], want):
                raise SystemExit(f"{route} filled the wrong bytes")
            times = []
            for _ in range(a.reps):
                t0 = time.perf_counter()
                fill()
                times.append((time.perf_counter() - t0) * 1e3)
            med = statistics.median(times)
            got[route] = {"ms": med, "ms_range": [min(times), max(times)],
                          "gbs": want.size / med / 1e6,
                          "contended": _contended(fill, want.size, idle)}
        out["sets"][name] = {"texts": len(texts), "bytes": int(want.size),
                             "routes": got}
    pool.shutdown()
    line = json.dumps(out)
    print(line, flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(card + "\n" + line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
