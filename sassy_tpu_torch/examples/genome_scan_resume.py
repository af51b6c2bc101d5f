"""Checkpointed, pipelined genome scanning (beyond the reference's
surface: SURVEY §5 notes the reference has no checkpoint/resume).

Shows the two long-scan tools this framework adds:

1. ``GenomeScan`` — library-level segment-checkpointed scanning: kill the
   process at any point, rerun, and the output TSV completes
   byte-identically to an uninterrupted run.
2. ``candidates_many_async`` — dispatch batch N+1's device scan before
   fetching batch N's results, so the host work overlaps device compute
   (the crispr/grep CLIs do this internally; the CLI equivalents are
   ``--resume progress.json`` and automatic).

Run: python -m sassy_tpu_torch.examples.genome_scan_resume [--device cpu]
Its files go to a fresh temporary directory (``workdir`` of ``main``).
"""

import tempfile
import time
from pathlib import Path

import numpy as np

from sassy_tpu_torch import Searcher, profiles
from sassy_tpu_torch.examples import device_arg
from sassy_tpu_torch.ops.batch import BatchEngine
from sassy_tpu_torch.scan import GenomeScan

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def main(device: str = "cuda", workdir=None):
    if workdir is None:
        with tempfile.TemporaryDirectory() as tmp:
            return main(device, tmp)
    rng = np.random.default_rng(0)
    tmp = Path(workdir)

    # a small "genome" with planted guide sites
    guide = bytes(rng.choice(BASES, size=23))
    contigs = []
    for i in range(4):
        body = bytearray(rng.choice(BASES, size=200_000))
        body[50_000 : 50_023] = guide
        contigs.append((f"chr{i}", bytes(body)))
    fa = tmp / "genome.fa"
    with open(fa, "w") as f:
        for rid, seq in contigs:
            f.write(f">{rid}\n{seq.decode()}\n")

    # 1. checkpointed scan: progress.json advances per segment; rerunning
    #    after a kill resumes (and truncates any partially written unit)
    s = Searcher(profiles.Iupac(), rc=True, device=device)
    gs = GenomeScan(s, segment_chars=1 << 17, checkpoint=str(tmp / "progress.json"))
    t0 = time.perf_counter()
    total = gs.scan(str(fa), [guide], 2, str(tmp / "matches.tsv"))
    print(f"scan: {total} matches in {time.perf_counter() - t0:.2f}s "
          f"(checkpoint: {tmp / 'progress.json'})")

    # 2. async pipelining: batch N+1 dispatched before batch N is fetched
    be = BatchEngine(device)
    prof = profiles.Iupac()
    gcode = prof.encode(np.frombuffer(guide, dtype=np.uint8))
    batches = [
        [np.frombuffer(seq, dtype=np.uint8)] for _, seq in contigs
    ]
    t0 = time.perf_counter()
    prev = None
    n_matches = 0
    for batch in batches:
        fin = be.candidates_many_async(prof, [gcode], batch, 2)
        if prev is not None:
            n_matches += sum(len(c) for c in prev()[0])
        prev = fin
    n_matches += sum(len(c) for c in prev()[0])
    print(f"pipelined batches: {n_matches} candidates in "
          f"{time.perf_counter() - t0:.2f}s")
    return (tmp / "matches.tsv").read_text(), n_matches


if __name__ == "__main__":
    main(device_arg(__doc__))
