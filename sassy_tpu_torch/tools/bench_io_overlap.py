"""I/O and compute overlap of the crispr command line.

    python -m sassy_tpu_torch.tools.bench_io_overlap [--mb 128]
        [--guides 32] [--gzip] [--device cuda|cpu]

The port of the reference's ``scripts/bench_io_overlap.py:33-145``. The
CLI overlaps FASTA parsing with the search: a reader thread
(``io.fastx.prefetch``) parses batch N+1 while batch N's dispatch runs.
On a random genome of ``--mb`` million bases (one record, written with
``--guides`` guides of 20 random bases + AGG under ``build/io_overlap/``):

- (a) parse-only: the record batches (32 MiB each) through
  ``io.fastx.read_fastx``;
- (b) device-only: the pre-parsed batches through
  ``Searcher.search_many_with_fn_async`` (k=3, both strands, all minima,
  ``max_n_frac`` 0.2: crispr's engine calls), depth 2, after one warm call;
- (d) steady: the batches parsed anew from the file through the reader
  thread, searched as in (b);
- (c) end to end: ``python -m sassy_tpu_torch --device <device> crispr``
  in a subprocess, its wall and the ``Time taken`` it prints; the child
  reports the modules it imported, and one of JAX or the reference
  package fails the run.

Then the wall of (c) against the serial model a + b and the overlapped
model max(a, b). Prints the card's name and power limit, the lines and one
JSON line.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from .timing import open_device

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
ROOT = Path(__file__).resolve().parents[2]
WORKDIR = ROOT / "build" / "io_overlap"
K = 3
BATCH_BYTES = 32 << 20
SEED = 11  # the reference script's
#: the child: the port's CLI as ``python -m sassy_tpu_torch`` runs it, then
#: the modules of JAX or the reference package it imported, on stderr
_CHILD = (
    "import runpy, sys\n"
    "sys.argv = ['sassy_tpu_torch', *sys.argv[1:]]\n"
    "try:\n"
    "    runpy.run_module('sassy_tpu_torch', run_name='__main__',"
    " alter_sys=True)\n"
    "finally:\n"
    "    bad = sorted(m for m in sys.modules"
    " if m.split('.')[0] in ('jax', 'sassy_tpu'))\n"
    "    print('imported: ' + ','.join(bad), file=sys.stderr)\n"
)


def write_inputs(genome_mb: float, n_guides: int, use_gzip: bool,
                 workdir: Path):
    """(genome FASTA path, guides path, bases) as the reference script
    writes them."""
    n = int(genome_mb * 1_000_000)
    rng = np.random.default_rng(SEED)
    genome = rng.choice(BASES, size=n)
    workdir.mkdir(parents=True, exist_ok=True)
    fa = workdir / ("genome.fa" + (".gz" if use_gzip else ""))
    raw = b">chr1\n" + genome.tobytes() + b"\n"
    if use_gzip:
        with gzip.open(fa, "wb", compresslevel=1) as f:
            f.write(raw)
    else:
        fa.write_bytes(raw)
    # crispr needs every guide to end in the same PAM: 20 bases + AGG
    guides = [bytes(rng.choice(BASES, size=20)) + b"AGG"
              for _ in range(n_guides)]
    gf = workdir / "guides.txt"
    gf.write_bytes(b"\n".join(guides) + b"\n")
    return fa, gf, guides, n


def run(genome_mb: float = 128, n_guides: int = 32, device="cuda",
        use_gzip: bool = False, workdir: Path | None = None,
        log=print) -> dict:
    from .. import Searcher, profiles
    from ..io import fastx

    workdir = Path(workdir or WORKDIR)
    fa, gf, guides, n = write_inputs(genome_mb, n_guides, use_gzip, workdir)

    def record_batches():
        pending, pb = [], 0
        for rec in fastx.read_fastx(str(fa)):
            pending.append(rec)
            pb += len(rec.seq)
            if pb >= BATCH_BYTES:
                yield pending
                pending, pb = [], 0
        if pending:
            yield pending

    t0 = time.perf_counter()
    batches = list(record_batches())
    t_parse = time.perf_counter() - t0
    log(f"(a) parse-only:  {t_parse:7.2f}s "
        f"({n / t_parse / 1e6:.0f} MB/s, {len(batches)} batches)")

    searcher = Searcher(profiles.Iupac(), rc=True,
                        device=device).with_max_n_frac(0.2)

    def search(source):
        nm, fin_prev = 0, None
        for recs in source:
            fin = searcher.search_many_with_fn_async(
                guides, [r.seq for r in recs], K, True, None)
            if fin_prev is not None:
                nm += len(fin_prev())
            fin_prev = fin
        return nm + len(fin_prev())

    search(batches[:1])  # warm
    t0 = time.perf_counter()
    nm = search(batches)
    t_dev = time.perf_counter() - t0
    log(f"(b) device-only: {t_dev:7.2f}s ({nm} matches)")

    t0 = time.perf_counter()
    nm2 = search(fastx.prefetch(record_batches()))
    t_steady = time.perf_counter() - t0
    log(f"(d) steady parse+search (reader thread overlap): {t_steady:7.2f}s"
        f" ({nm2} matches)")

    out_tsv = workdir / "crispr.tsv"
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", _CHILD, "--device", str(device), "crispr",
         "-g", str(gf), "-k", str(K), "--max-n-frac", "0.2",
         "-o", str(out_tsv), str(fa)],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "SASSY_NO_BANNER": "1"},
    )
    t_e2e = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"crispr exited {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    imported = [ln for ln in r.stderr.splitlines()
                if ln.startswith("imported: ")]
    if imported != ["imported: "]:
        raise RuntimeError(f"the crispr child imported JAX or the reference "
                           f"package: {imported}")
    inner = [ln.strip() for ln in r.stdout.splitlines() if "Time taken" in ln]
    rows = sum(1 for ln in out_tsv.read_text().splitlines()[1:] if ln)
    log(f"(c) crispr e2e:  {t_e2e:7.2f}s process wall "
        f"({inner[0] if inner else 'n/a'}; {rows} rows)")
    log(f"    serial model (a+b):     {t_parse + t_dev:7.2f}s")
    log(f"    overlapped model max(): {max(t_parse, t_dev):7.2f}s")
    return {"tool": "bench_io_overlap", "device": str(device), "n": n,
            "guides": n_guides, "gzip": use_gzip, "batches": len(batches),
            "parse_s": t_parse, "device_s": t_dev, "steady_s": t_steady,
            "e2e_s": t_e2e, "e2e_inner": inner[0] if inner else None,
            "matches": nm, "steady_matches": nm2, "cli_rows": rows,
            "serial_s": t_parse + t_dev,
            "overlapped_s": max(t_parse, t_dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float, default=128,
                    help="genome size, million bases")
    ap.add_argument("--guides", type=int, default=32)
    ap.add_argument("--gzip", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev, card = open_device("bench_io_overlap", a.device)
    if dev is None:
        return 2
    rec = run(a.mb, a.guides, dev, a.gzip, log=lambda msg: print(msg, flush=True))
    if card:
        rec["card"] = card
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
