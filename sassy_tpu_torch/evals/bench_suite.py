"""Eval harness: the reference's benchmark suite on an NVIDIA GPU.

The port's own copy of ``evals/bench_suite.py`` over the port's engines.
It runs the four sassy2 benchmarks (text-scaling, pattern-scaling, nanopore
barcodes, CRISPR off-targets; the reference's evals/src/main.rs:14-98 and
benchsuite/bench.rs) and the sassy1 single-pattern throughput benches,
with the same CSV schema, so rows are directly comparable with the
committed reference CSVs (evals/src/sassy2/output-xeon-512/*.csv) and with
the JAX package's ``evals/output-v5e/``.

Tools:
- ``search``  = one pattern at a time (the reference's Sassy1 column): one
  batched-engine dispatch per pattern over the whole text set, all of
  them in flight before the first fetch.
- ``tiling``  = the batched cartesian engine (the Sassy2 column): one
  dispatch for the whole pattern batch x text set.
- ``edlib`` columns hold the independent C++ cost oracle
  (native/refcost.cc, built by ``sassy_tpu_torch.refcost``; edlib is not
  installable here): its end-cost rate is measured on a bounded
  sub-workload and projected to the row's full byte count (rate-based,
  like all throughput columns).
- ``*_ipc`` columns are 0 (no hardware counters are read).

The scans run on ``--device`` (default ``cuda``, or ``SASSY_DEVICE``): the
q2meta kernel for ``search`` and ``tiling``, q1meta for the throughput
rows. ``cuda`` without a card raises; there is no fallback to the CPU.
``cpu`` runs the kernels' plain PyTorch versions, for tests at tiny sizes.

Short-text rows (text_scaling, pattern_scaling) are measured AMORTIZED: R
copies of the text go through ONE dispatch (R sized by ``amortize_to_bp``)
and the time is reported per instance: steady-state engine throughput
rather than the fixed cost of a dispatch.

Benchmark parameters live in evals/configs/*.toml (the reference keeps
per-benchmark TOML configs the same way, evals/src/sassy2/configs/).

Throughput accounting matches bench.rs:240-242: scaling benches count
text_len x num_patterns bytes; read/genome benches count raw text bytes.

Text preparation (upload and pack of a text set, the prepared text of a
throughput row) is done once, untimed, as the reference pre-encodes its
v2 chunks untimed; every timed call ends with its candidates on the host.

Usage: python -m sassy_tpu_torch.evals.bench_suite {text_scaling,
pattern_scaling,nanopore,off_targets,nanopore_full,off_targets_full,
throughput_m,throughput_n,all} [--out evals/output-h100] [--scale 1.0]
[--reps 3] [--device cuda]
"""

from __future__ import annotations

import argparse
import csv
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import refcost
from ..ops.batch import BatchEngine, TextSet
from ..ops.myers_torch import TorchEngine
from ..profiles import Iupac

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

CONFIG_DIR = Path(__file__).resolve().parents[2] / "evals" / "configs"

#: draws of one ``sim_text`` chunk: a chunk's int64 indices take 512 MiB
SIM_CHUNK = 1 << 26


def load_config(name: str) -> dict:
    """Per-benchmark TOML config (evals/configs/<name>.toml)."""
    import tomllib

    with open(CONFIG_DIR / f"{name}.toml", "rb") as fh:
        return tomllib.load(fh)


def refcost_rate_bps(prof, queries, text, k) -> float:
    """Bytes/s of the independent C++ DP (native/refcost.cc) on a bounded
    sub-workload: the role of the reference's edlib baseline column."""
    if refcost.load() is None:
        return 0.0
    sub = text[: min(len(text), 1 << 20)]
    nq = min(len(queries), 2)
    t0 = time.perf_counter()
    for q in queries[:nq]:
        refcost.end_costs(prof, bytes(q), bytes(sub), None)
    dt = time.perf_counter() - t0
    return nq * len(sub) / dt if dt > 0 else 0.0


HEADER = (
    "num_queries,target_len,query_len,k,"
    "search_median_ms,search_mean_ms,search_std_ms,search_ci_lower_ms,"
    "search_ci_upper_ms,search_n_matches,"
    "tiling_median_ms,tiling_mean_ms,tiling_std_ms,tiling_ci_lower_ms,"
    "tiling_ci_upper_ms,tiling_n_matches,"
    "edlib_median_ms,edlib_mean_ms,edlib_std_ms,edlib_ci_lower_ms,"
    "edlib_ci_upper_ms,edlib_n_matches,"
    "search_ipc,tiling_ipc,edlib_ipc,"
    "search_throughput_gbps,search_ci_lower_throughput_gbps,"
    "search_ci_upper_throughput_gbps,"
    "tiling_throughput_gbps,tiling_ci_lower_throughput_gbps,"
    "tiling_ci_upper_throughput_gbps,"
    "edlib_throughput_gbps,edlib_ci_lower_throughput_gbps,"
    "edlib_ci_upper_throughput_gbps,throughput_bytes"
).split(",")


def sim_text(rng, n: int, queries=(), plant_every: int = 0, k: int = 0):
    """Random DNA; optionally plant mutated query copies every
    ``plant_every`` bp (the analog of benchsuite/sim_data.rs). The draws
    come in chunks of ``SIM_CHUNK``, which give the bytes (and leave the
    generator in the state) of one ``rng.choice(BASES, size=n)`` without
    its n int64 indices."""
    text = np.empty(n, dtype=np.uint8)
    for c0 in range(0, n, SIM_CHUNK):
        c1 = min(n, c0 + SIM_CHUNK)
        text[c0:c1] = rng.choice(BASES, size=c1 - c0)
    if queries and plant_every:
        pos = plant_every
        qi = 0
        while pos + len(queries[0]) < n:
            q = queries[qi % len(queries)].copy()
            for _ in range(rng.integers(0, k + 1)):
                q[rng.integers(0, len(q))] = rng.choice(BASES)
            text[pos : pos + len(q)] = q
            pos += plant_every
            qi += 1
    return text


def device_text(n: int, device) -> torch.Tensor:
    """n random ACGT bytes made on ``device`` from a generator seeded with
    n (the throughput rows' texts)."""
    gen = torch.Generator(device=device).manual_seed(n)
    idx = torch.randint(0, 4, (n,), generator=gen, device=device,
                        dtype=torch.uint8)
    return torch.from_numpy(BASES.copy()).to(device)[idx.long()]


def stats_row(times_ms: list[float], n_matches: int, tbytes: int):
    med = statistics.median(times_ms)
    mean = statistics.fmean(times_ms)
    std = statistics.pstdev(times_ms) if len(times_ms) > 1 else 0.0
    lo, hi = min(times_ms), max(times_ms)
    gb = lambda ms: tbytes / (ms * 1e6) if ms > 0 else 0.0  # noqa: E731
    return (
        [f"{med:.3f}", f"{mean:.3f}", f"{std:.3f}", f"{lo:.3f}", f"{hi:.3f}",
         n_matches],
        [f"{gb(med):.3f}", f"{gb(hi):.3f}", f"{gb(lo):.3f}"],
    )


class Runner:
    def __init__(self, reps: int = 3, device="cuda"):
        self.prof = Iupac()
        self.engine = TorchEngine(device)
        self.batch = BatchEngine(device)
        self.device = self.batch.device
        self.reps = reps
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "host")
        print(f"[evals] device={self.device} ({name})", file=sys.stderr)
        self._reset_peak()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _reset_peak(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def run_case(self, queries: list[np.ndarray], texts: list[np.ndarray], k: int):
        """Returns (search_times_ms, search_matches, tiling_times_ms,
        tiling_matches). ``search`` = one pattern at a time (the Sassy1
        analog); ``tiling`` = whole pattern batch in one dispatch."""
        prof = self.prof
        qcodes = [prof.encode(q) for q in queries]
        ts = TextSet(texts, self.device)

        def t_search():
            # per-pattern dispatches, ALL in flight before the first fetch:
            # they queue on the engines' one dispatch thread, so the host
            # work of one (selection waits, the result's copy) overlaps the
            # device work of the next (the reference's sassy1 column runs
            # its pattern x text-chunk work items on 16 threads
            # concurrently, evals/src/benchsuite/bench.rs:546-610)
            n = 0
            t0 = time.perf_counter()
            fins = [
                self.batch.candidates_many_flat_async(prof, [qc], ts, k)
                for qc in qcodes
            ]
            for fin in fins:
                n += len(fin()[0])
            return (time.perf_counter() - t0) * 1e3, n

        def t_tiling():
            # two back-to-back batch dispatches, reported per call: the
            # steady-state rate of a scanning workload (the host work of
            # call 1 overlaps the device work of call 2). Flat output: the
            # reference's v2 engine likewise returns a flat Vec<Match>, not
            # a dense per-(pattern, text) nesting (general.rs:335-350)
            t0 = time.perf_counter()
            f1 = self.batch.candidates_many_flat_async(prof, qcodes, ts, k)
            f2 = self.batch.candidates_many_flat_async(prof, qcodes, ts, k)
            res = f1()
            f2()
            dt = (time.perf_counter() - t0) * 1e3 / 2
            return dt, len(res[0])

        t_search()  # warmup: upload + pack of the text set, kernel load
        t_tiling()

        def measure():
            s_times, s_n = [], 0
            t_times, t_n = [], 0
            for _ in range(self.reps):
                dt, s_n = t_search()
                s_times.append(dt)
                dt, t_n = t_tiling()
                t_times.append(dt)
            return s_times, s_n, t_times, t_n

        s_times, s_n, t_times, t_n = measure()
        # a rep polluted by a host hiccup shows as std >> median.
        # Re-measure once and keep the cleaner set.
        for times in (s_times, t_times):
            med = statistics.median(times)
            if med > 0 and statistics.pstdev(times) > 0.5 * med:
                print(f"[evals] outlier reps {['%.0f' % t for t in times]} "
                      "(std > 50% of median); re-measuring once",
                      file=sys.stderr)
                s2, s_n2, t2, t_n2 = measure()
                spread = lambda ts: statistics.pstdev(ts) / max(  # noqa:E731
                    statistics.median(ts), 1e-9)
                if spread(s2) + spread(t2) < spread(s_times) + spread(t_times):
                    s_times, s_n, t_times, t_n = s2, s_n2, t2, t_n2
                break
        return s_times, s_n, t_times, t_n

    def emit(self, w, num_q, target_len, query_len, k, s_times, s_n,
             t_times, t_n, tbytes, ref_bps: float = 0.0):
        s_stats, s_tp = stats_row(s_times, s_n, tbytes)
        t_stats, t_tp = stats_row(t_times, t_n, tbytes)
        if ref_bps > 0:
            ref_ms = tbytes / ref_bps * 1e3
            e_stats = [f"{ref_ms:.3f}"] * 2 + ["0.000", f"{ref_ms:.3f}",
                                               f"{ref_ms:.3f}", 0]
            e_tp = [f"{ref_bps / 1e9:.3f}"] * 3
        else:
            e_stats = ["0.000"] * 5 + [0]
            e_tp = ["0.000"] * 3
        row = (
            [num_q, target_len, query_len, k]
            + s_stats + t_stats
            + e_stats                       # refcost (edlib-role) columns
            + ["0.00", "0.00", "0.00"]      # ipc
            + s_tp + t_tp + e_tp            # throughputs
            + [tbytes]
        )
        w.writerow(row)
        peak = "not measured"
        if self.device.type == "cuda":
            peak = (f"{torch.cuda.max_memory_allocated(self.device) / 2**30:.3f}"
                    " GiB")
            self._reset_peak()
        print(f"[evals] row q={num_q} n={target_len} m={query_len} k={k}: "
              f"search {s_tp[0]} GB/s, tiling {t_tp[0]} GB/s, "
              f"{s_n}/{t_n} matches, peak device memory {peak}",
              file=sys.stderr)


def bench_text_scaling(r: Runner, w, scale: float):
    cfg = load_config("text_scaling")
    rng = np.random.default_rng(1)
    target_len = int(cfg["target_len"] * scale)
    query_len, k = cfg["query_len"], cfg["k"]
    text = sim_text(rng, target_len)
    reps = max(1, int(cfg.get("amortize_to_bp", 0) * scale) // target_len)
    texts = [text] * reps
    for num_q in cfg["num_queries"]:
        queries = [rng.choice(BASES, size=query_len) for _ in range(num_q)]
        ref = refcost_rate_bps(r.prof, queries, text, k)
        s_t, s_n, t_t, t_n = r.run_case(queries, texts, k)
        r.emit(
            w, num_q, target_len, query_len, k,
            [t / reps for t in s_t], s_n // reps,
            [t / reps for t in t_t], t_n // reps,
            target_len * num_q, ref,
        )


def bench_pattern_scaling(r: Runner, w, scale: float):
    cfg = load_config("pattern_scaling")
    rng = np.random.default_rng(2)
    num_q, query_len = cfg["num_queries"], cfg["query_len"]
    queries = [rng.choice(BASES, size=query_len) for _ in range(num_q)]
    for target_len in cfg["target_lens"]:
        tl = max(query_len + 1, int(target_len * scale))
        text = sim_text(rng, tl)
        # amortized: R text instances in ONE dispatch, reported per instance
        reps = max(1, int(cfg["amortize_to_bp"] * scale) // tl)
        texts = [text] * reps
        for k in cfg["ks"]:
            ref = refcost_rate_bps(r.prof, queries, text, k)
            s_t, s_n, t_t, t_n = r.run_case(queries, texts, k)
            r.emit(
                w, num_q, tl, query_len, k,
                [t / reps for t in s_t], s_n // reps,
                [t / reps for t in t_t], t_n // reps,
                tl * num_q, ref,
            )


def nanopore_data(cfg: dict, scale: float):
    """The nanopore bench's barcodes and reads (seed 3)."""
    rng = np.random.default_rng(3)
    total_bp = int(cfg["total_bp"] * scale)
    read_len = cfg["read_len"]
    queries = [rng.choice(BASES, size=cfg["query_len"])
               for _ in range(cfg["num_queries"])]
    texts = [
        sim_text(rng, read_len, queries, plant_every=cfg["plant_every"], k=3)
        for _ in range(total_bp // read_len)
    ]
    return queries, texts


def off_target_data(cfg: dict, scale: float):
    """The off-target bench's guides and genome (seed 4)."""
    rng = np.random.default_rng(4)
    num_q = max(4, int(cfg["num_queries"] * min(scale * 4, 1.0)))
    queries = [rng.choice(BASES, size=cfg["query_len"]) for _ in range(num_q)]
    text = sim_text(rng, int(cfg["genome_bp"] * scale), queries,
                    plant_every=cfg["plant_every"], k=cfg["k"])
    return queries, text


def bench_nanopore(r: Runner, w, scale: float, cfg_name: str = "nanopore"):
    """96 barcodes x simulated reads (the nanopore benchmark shape,
    reference: 334 Mbp of reads; 'nanopore_full' runs the full 334 Mbp)."""
    cfg = load_config(cfg_name)
    queries, texts = nanopore_data(cfg, scale)
    total_bp = int(cfg["total_bp"] * scale)
    for k in cfg["ks"]:
        ref = refcost_rate_bps(r.prof, queries, texts[0], k)
        s_t, s_n, t_t, t_n = r.run_case(queries, texts, k)
        r.emit(w, len(queries), total_bp, cfg["query_len"], k, s_t, s_n,
               t_t, t_n, total_bp, ref)


def bench_off_targets(r: Runner, w, scale: float,
                      cfg_name: str = "off_targets"):
    """CRISPR guides x one genome-scale text (reference: 312 guides x
    3.12 Gbp; 'off_targets_full' runs the full reference shape)."""
    cfg = load_config(cfg_name)
    queries, text = off_target_data(cfg, scale)
    k = cfg["k"]
    ref = refcost_rate_bps(r.prof, queries, text, k)
    s_t, s_n, t_t, t_n = r.run_case(queries, [text], k)
    r.emit(w, len(queries), len(text), cfg["query_len"], k, s_t, s_n, t_t,
           t_n, len(text), ref)


def _bench_single(r: Runner, w, configs):
    """Single-pattern engine rows (the sassy1 throughput benches,
    evals/src/main.rs:14-40): device-resident text, one dispatch per
    search (the q1meta kernel)."""
    rng = np.random.default_rng(5)
    for m, n, k in configs:
        prep = r.engine.prepare(r.prof, device_text(n, r.device))
        r._sync()  # the pack, untimed
        pat = r.prof.encode(rng.choice(BASES, size=m))

        def one():
            t0 = time.perf_counter()
            c = r.engine.candidates(r.prof, pat, prep, k, None, None, False)
            return (time.perf_counter() - t0) * 1e3, len(c)

        def pipelined(reps):
            # depth-2 async pipelining: the host work of call i (selection
            # waits, the copy) overlaps the device work of call i+1 (the
            # steady-state rate a scanning workload sees; same methodology
            # as bench.py)
            t0 = time.perf_counter()
            prev = r.engine.candidates_async(
                r.prof, pat, prep, k, None, None, False)
            for _ in range(reps - 1):
                nxt = r.engine.candidates_async(
                    r.prof, pat, prep, k, None, None, False)
                c = prev()
                prev = nxt
            c = prev()
            return (time.perf_counter() - t0) * 1e3 / reps, len(c)

        one()  # warmup: windows of this plan, kernel load
        times, nm = [], 0
        for _ in range(r.reps):
            dt, nm = pipelined(4)
            times.append(dt)
        r.emit(w, 1, n, m, k, times, nm, [0.0], 0, n)
        del prep


def bench_throughput_m(r: Runner, w, scale: float):
    cfg = load_config("throughput")["throughput_m"]
    n = int(cfg["n"] * scale)
    _bench_single(r, w, [(m, n, cfg["k"]) for m in cfg["ms"]])


def bench_throughput_n(r: Runner, w, scale: float):
    cfg = load_config("throughput")["throughput_n"]
    _bench_single(
        r, w,
        [(cfg["m"], int(n * scale), cfg["k"]) for n in cfg["ns"]],
    )


BENCHES = {
    "text_scaling": bench_text_scaling,
    "pattern_scaling": bench_pattern_scaling,
    "nanopore": bench_nanopore,
    "off_targets": bench_off_targets,
    "nanopore_full": lambda r, w, s: bench_nanopore(
        r, w, s, cfg_name="nanopore_full"
    ),
    "off_targets_full": lambda r, w, s: bench_off_targets(
        r, w, s, cfg_name="off_targets_full"
    ),
    "throughput_m": bench_throughput_m,
    "throughput_n": bench_throughput_n,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "sassy_tpu_torch.evals.bench_suite")
    ap.add_argument("bench", choices=[*BENCHES, "all"])
    ap.add_argument("--out", default="evals/output-h100")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="Data size multiplier (1.0 = default scaled sizes)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument(
        "--device", default=os.environ.get("SASSY_DEVICE", "cuda"),
        choices=["cuda", "cpu"],
        help="Device to search on (default cuda; also settable via "
             "SASSY_DEVICE). 'cpu' runs the kernels' plain PyTorch "
             "versions; 'cuda' without a CUDA device raises.",
    )
    args = ap.parse_args(argv)

    r = Runner(reps=args.reps, device=args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    names = list(BENCHES) if args.bench == "all" else [args.bench]
    for name in names:
        path = out / f"{name}_results.csv"
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(HEADER)
            t0 = time.perf_counter()
            BENCHES[name](r, w, args.scale)
            print(f"[evals] {name}: {time.perf_counter() - t0:.1f}s -> {path}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
