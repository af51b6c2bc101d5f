"""Time the scan kernels of two checkouts of the port on one GPU, in turns.

    python -m sassy_tpu_torch.tools.compare_builds OLD_ROOT NEW_ROOT \
        [--turns 2] [--out FILE]

Each run is a fresh process that imports the ``sassy_tpu_torch`` of one
checkout root, builds that checkout's kernel library from its own sources,
and times its kernels with CUDA events (mean of ``--reps`` launches after
one warm-up), at ``chip_smoke.py``'s shapes:

- q1meta (``scan_meta``) over the windows of 1 GiB of random ACGT, a 23 bp
  pattern at k=3, for the pure and the iupac eq (phase 2's headline);
- q2meta (``scan_q_meta``), where the checkout has it, on the first
  dispatch chunk of the nanopore read set: 96 random 24 bp barcodes over
  10 kbp reads, k=3, as ``BatchEngine.scan`` launches it (phase 5's
  headline);
- with ``--search-many N``, where the checkout has the batched engine:
  ``Searcher("dna", rc=True).search_many`` of the 96 barcodes over N
  random 10 kbp reads, both strands, end to end (host clock), and, for
  the first and the second call in the process, the time
  ``candidates_many_async`` of both strands takes to return and to
  finish; with ``--plant`` as well, each read holds one copy of a barcode
  with one substitution at offset 5000 (read i: barcode i % 96, even
  reads forward, odd reads reverse-complemented, as ``chip_smoke.py``
  phase 6 plants them), so that the host traceback of one match per read
  takes most of the call.

The runs go OLD, NEW, NEW, OLD for ``--turns 2`` (ABBA per turn), so a
drift of the card's clocks falls on both. Prints the card's name and
power limit, then one JSON line per run; ``--out`` also writes them there.
Inputs come from ``--seed``, the same in every run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

PATTERN_LEN = 23
BARCODE_LEN = 24
N_BARCODES = 96
READ_LEN = 10_000
#: more reads than one dispatch chunk takes (8,710 pieces of 321 words)
N_READS = 9_000
K = 3
PLANT_AT = 5_000
MUT_AT = 11


def _cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _child(root: str, seed: int, mib: int, reps: int,
           search_reads: int, plant: bool) -> dict:
    """One run: the kernels of the checkout at ``root``."""
    sys.path.insert(0, root)
    import torch

    from sassy_tpu_torch import profiles
    from sassy_tpu_torch.ops import myers_cuda
    from sassy_tpu_torch.ops.myers_torch import TorchEngine

    if not Path(myers_cuda.__file__).resolve().is_relative_to(
            Path(root).resolve()):
        raise SystemExit(f"imported {myers_cuda.__file__}, not from {root}")
    myers_cuda.build()
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    bases = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)

    def acgt(n: int):
        return bases[torch.randint(0, 4, (n,), generator=gen, device=dev)]

    dna = profiles.Dna()
    out = {"root": root}
    eng = TorchEngine(dev)
    prep = eng.prepare(dna, acgt(mib << 20))
    pattern = acgt(PATTERN_LEN).cpu().numpy()
    for mode in ("pure", "iupac"):
        inp = eng.build_inputs(dna, dna.encode(pattern), prep, K)
        inp.eq_mode = mode
        args = (inp.windows, inp.tile0, inp.valid_from, inp.valid_to,
                inp.pmasks, inp.is_pad, inp.h_init, inp.m_real,
                inp.boundary_m, inp.k, inp.eq_mode)
        out[f"q1meta_{mode}_ms"] = _cuda_ms(
            lambda: myers_cuda.scan_meta(*args), reps)
    del prep, inp, args
    if hasattr(myers_cuda, "scan_q_meta"):
        from sassy_tpu_torch.ops.batch import BatchEngine, TextSet

        beng = BatchEngine(dev)
        barcodes = acgt(N_BARCODES * BARCODE_LEN).cpu().numpy()
        codes = [dna.encode(b) for b in barcodes.reshape(N_BARCODES, -1)]
        reads = acgt(N_READS * READ_LEN).cpu().numpy().reshape(N_READS, -1)
        ts = TextSet(list(reads), dev)
        (g,) = beng.groups(dna, codes, ts, K)
        pp = ts.piece_plan(g.halo, g.w_chars)
        q0, q1, t0, t1 = next(beng.chunks(g, pp))
        win = ts.windows(dna, pp, False, t0, t1)
        out["q2meta_shape"] = [q1 - q0, pp.NW, t1 - t0]
        out["q2meta_pure_ms"] = _cuda_ms(
            lambda: beng.scan(win, g, pp, q0, q1, t0, t1, K), reps)
        del ts, win, reads
        if search_reads:
            out.update(_search_many(dna, barcodes.reshape(N_BARCODES, -1),
                                    acgt, search_reads, plant))
    return out


def _search_many(dna, barcodes, acgt, n_reads: int, plant: bool) -> dict:
    import time

    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher
    from sassy_tpu_torch.ops.batch import BatchEngine, TextSet

    reads = acgt(n_reads * READ_LEN).cpu().numpy().reshape(n_reads, -1)
    if plant:
        mutated = barcodes.copy()
        col = mutated[:, MUT_AT]
        mutated[:, MUT_AT] = np.where(col != ord("A"), ord("A"), ord("C"))
        rc = np.frombuffer(
            b"".join(dna.reverse_complement(m) for m in mutated), np.uint8
        ).reshape(mutated.shape)
        i = np.arange(n_reads)
        site = slice(PLANT_AT, PLANT_AT + barcodes.shape[1])
        reads[0::2, site] = mutated[i[0::2] % len(barcodes)]
        reads[1::2, site] = rc[i[1::2] % len(barcodes)]
    reads = list(reads)
    pcodes = [dna.encode(b) for b in barcodes]
    ccodes = [dna.encode(np.frombuffer(dna.complement(b), np.uint8))
              for b in barcodes]
    out = {"search_reads": n_reads, "planted": plant, "async_return_ms": [],
           "both_finish_ms": []}
    for _ in ("first", "second"):
        eng = BatchEngine("cuda")
        ts = TextSet(reads, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin = eng.candidates_many_async(dna, pcodes, ts, K)
        rfin = eng.candidates_many_async(dna, ccodes, ts, K, reverse=True)
        t1 = time.perf_counter()
        fin()
        rfin()
        t2 = time.perf_counter()
        out["async_return_ms"].append((t1 - t0) * 1e3)
        out["both_finish_ms"].append((t2 - t0) * 1e3)
        del eng, ts, fin, rfin
    searcher = Searcher("dna", rc=True, device="cuda")
    t0 = time.perf_counter()
    matches = searcher.search_many(list(barcodes), reads, K)
    out["search_many_s"] = time.perf_counter() - t0
    out["matches"] = len(matches)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--mib", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--search-many", type=int, default=0, metavar="N_READS")
    ap.add_argument("--plant", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        print(json.dumps(_child(a.child, a.seed, a.mib, a.reps,
                                a.search_many, a.plant)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    lines = [card]
    order = []
    for turn in range(a.turns):
        order += [a.old, a.new] if turn % 2 == 0 else [a.new, a.old]
    for root in order:
        proc = subprocess.run(
            [sys.executable, __file__, a.old, a.new, "--child",
             str(Path(root).resolve()), "--seed", str(a.seed), "--mib",
             str(a.mib), "--reps", str(a.reps), "--search-many",
             str(a.search_many)] + (["--plant"] if a.plant else []),
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise SystemExit(f"run of {root} failed:\n{proc.stderr}")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        lines.append(line)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
