"""Enumerate every sufficiently-distinct alignment per match end
(the reference's examples/search_all_alignments.rs analog).

Run: python -m sassy_tpu_torch.examples.search_all_alignments [--device cpu]
"""

import numpy as np

from sassy_tpu_torch import Searcher, profiles
from sassy_tpu_torch.examples import device_arg

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def main(device: str = "cuda"):
    rng = np.random.default_rng(3)
    text = bytes(rng.choice(BASES, size=5000))
    pattern = text[1200:1224]  # guaranteed exact hit + nearby variants

    s = Searcher(profiles.Iupac(), rc=True, device=device)
    groups = s.search_all_alignments(pattern, text, k=2)
    print(f"{len(groups)} end-position groups")
    for g in groups[:5]:
        first = g[0]
        print(
            f"  anchor {first.text_start}-{first.text_end} "
            f"({len(g)} alignments): "
            + ", ".join(m.cigar.to_string() for m in g[:4])
        )
    return groups


if __name__ == "__main__":
    main(device_arg(__doc__))
