"""Timing comparison of the search batching modes
(the reference's examples/modes.rs analog): Single pair-by-pair loops vs
the batched texts/patterns paths, same match sets.

Run: python -m sassy_tpu_torch.examples.modes [--device cpu]
"""

import time

import numpy as np

from sassy_tpu_torch import Searcher, profiles
from sassy_tpu_torch.examples import device_arg

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
#: the workload: 24 bp patterns x random texts at k edits
N_PATTERNS = 16
N_TEXTS = 32
TEXT_LEN = 2000
K = 2


def main(device: str = "cuda"):
    rng = np.random.default_rng(0)
    k = K
    patterns = [bytes(rng.choice(BASES, size=24)) for _ in range(N_PATTERNS)]
    texts = [bytes(rng.choice(BASES, size=TEXT_LEN)) for _ in range(N_TEXTS)]

    s = Searcher(profiles.Iupac(), rc=True, device=device)

    def timed(name, fn):
        fn()  # warmup: kernel load, caches
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        print(f"{name:>24}: {dt * 1e3:8.1f} ms, {len(out)} matches")
        return out

    single = timed(
        "single (pair loop)",
        lambda: [
            m
            for pi, p in enumerate(patterns)
            for t in texts
            for m in s.search(p, t, k)
        ],
    )
    many = timed("search_many (batched)", lambda: s.search_many(patterns, texts, k))
    assert len(single) == len(many)

    enc = s.encode_patterns(patterns)
    encoded = timed(
        "encoded patterns",
        lambda: [m for t in texts for m in s.search_encoded_patterns(enc, t, k)],
    )
    return single, many, encoded


if __name__ == "__main__":
    main(device_arg(__doc__))
