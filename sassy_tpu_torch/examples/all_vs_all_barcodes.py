"""All-vs-all barcode comparison via encoded patterns
(the reference's examples/all_vs_all_barcodes.rs analog): semi-global
alignment of every barcode against every other.

Run: python -m sassy_tpu_torch.examples.all_vs_all_barcodes [--device cpu]
"""

import numpy as np

from sassy_tpu_torch import Searcher, profiles
from sassy_tpu_torch.examples import device_arg

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def main(device: str = "cuda"):
    rng = np.random.default_rng(7)
    barcodes = [bytes(rng.choice(BASES, size=24)) for _ in range(64)]
    k = 4

    s = Searcher(profiles.Iupac(), rc=False, device=device)
    matches = s.search_many(barcodes, barcodes, k)
    hits = [
        (m.pattern_idx, m.text_idx, m.cost)
        for m in matches
        if m.pattern_idx != m.text_idx
    ]
    print(f"{len(barcodes)} barcodes, k={k}: {len(hits)} cross matches")
    for pi, ti, cost in hits[:10]:
        print(f"  barcode {pi} ~ barcode {ti} (cost {cost})")
    return matches


if __name__ == "__main__":
    main(device_arg(__doc__))
