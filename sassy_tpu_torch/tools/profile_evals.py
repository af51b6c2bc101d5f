"""Where the time of one batched evals row goes on the card.

    python -m sassy_tpu_torch.tools.profile_evals [--bench nanopore_full]
        [--out FILE]

Makes the bench's data as ``sassy_tpu_torch.evals.bench_suite`` does (same
seeds, same bytes) and runs its two columns on the card, forward strand:

- the text set's preparation, untimed in the bench (host clock, each
  step ended by a synchronise): the staged upload of the texts' bytes
  (``TextSet.data``: two pinned staging buffers filled from the texts'
  own arrays), the tables of the text set's pack (``TextSet.tables``,
  for 0 and ``OVERSHOOT_STEPS`` steps), each strand's planes (one launch
  of the text set's pack kernel, ``TextSet.planes``) and the forward
  planes with ``OVERSHOOT_STEPS`` 'N' positions a text (an overhang
  search's); then each of those three launches alone under CUDA events
  (the mean of ``KERNEL_REPS``) beside ``diagnostics.pack_bound``, and
  the host memory numpy and Python allocate in a second preparation of
  the same texts (``tracemalloc``);
- the tiling group's piece plan, which its first call pays (host clock):
  the pieces cut by ``batch._plan_columns`` and, for comparison, by the
  per-piece loop ``batch._plan_pieces``, and the width and dispatch
  chunks it gives;
- tiling: one warm call of all patterns in one dispatch;
- search: one warm dispatch per pattern, all in flight before the first
  fetch, over the first ``SEARCH_PATTERNS`` patterns (the row's time
  scaled from them).

Each column runs once under ``torch.profiler``: its wall, the device time
of the q2meta kernel and of every other device op (the selection, the
tables of each chunk), the device's busy share, the kernel launches, the
window gathers (``myers_torch.windows_plain`` calls: none, since q2meta
reads each piece's window from the planes through its descriptor), and
the top ops
by device time (``--out`` writes the whole tables); for the tiling column
also q2meta's launches, its time a launch and its share of its bound
(``diagnostics.scan_bound`` summed over the dispatch chunks). Prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import time
import tracemalloc
from pathlib import Path

import torch
from torch.autograd import DeviceType

from .. import diagnostics
from ..evals import bench_suite
from ..ops import batch
from ..ops.batch import BatchEngine, TextSet
from ..ops.myers_torch import aligned_words, windows_plain
from ..profiles import Iupac

BENCHES = ("nanopore", "nanopore_full", "off_targets", "off_targets_full")
SEARCH_PATTERNS = 32
#: the overhang steps whose planes are timed: a 24 bp pattern at k=3 and
#: alpha 0.5 (chip_smoke.py's OH_WORD)
OVERSHOOT_STEPS = 7
#: launches of each pack timed under CUDA events
KERNEL_REPS = 5


def _plan(eng, prof, qcodes, ts, k) -> list:
    """Cut the tiling group's pieces (the first call's planning) and print
    its cost; returns the group's q2meta bounds, one a dispatch chunk."""
    (g,) = eng.groups(prof, qcodes, ts, k)
    t0 = time.perf_counter()
    cols = batch._plan_columns(ts.lens, g.steps, g.w_chars, g.halo)
    t_cols = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    loop = batch._plan_pieces(ts.lens, g.steps, g.w_chars, g.halo)
    t_loop = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pp = ts.piece_plan(g.halo, g.w_chars, g.steps)
    t_plan = (time.perf_counter() - t0) * 1e3
    chunks = list(eng.chunks(g, pp))
    threads = [(q1 - q0) * (t1 - t0) for q0, q1, t0, t1 in chunks]
    print(f"piece plan: {pp.T} pieces of {g.w_chars // 32} words (NW "
          f"{pp.NW}), {len(chunks)} dispatch chunks of up to "
          f"{max(threads)} threads; first call's plan {t_plan:.1f} ms "
          f"(the cut {t_cols:.1f} ms; the per-piece loop "
          f"{t_loop:.1f} ms, {len(loop)} pieces, equal "
          f"{len(loop) == len(cols['text_idx'])})", flush=True)
    P = ts.planes(prof, False).shape[0]
    return [diagnostics.scan_bound(g.eq_mode, q1 - q0, g.pmasks.shape[1],
                                   (pp.NW, P, t1 - t0), True)["bound_ms"]
            for q0, q1, t0, t1 in chunks]


def _ms(fn):
    """(result, host ms) of ``fn``, ended by a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fn()
    torch.cuda.synchronize()
    return got, (time.perf_counter() - t0) * 1e3


def _kernel_ms(fn) -> float:
    """Mean milliseconds of ``fn`` over KERNEL_REPS calls (CUDA events)
    after one warm call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(KERNEL_REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / KERNEL_REPS


def prepare(ts, prof) -> None:
    """The text set's preparation split into its steps (see the module's
    doc), printed; leaves both strands' planes cached."""
    steps = OVERSHOOT_STEPS
    data, t_up = _ms(ts.data)
    _, t_tab = _ms(lambda: (ts.tables(0), ts.tables(steps)))
    _, t_fwd = _ms(lambda: ts.planes(prof, False))
    _, t_rev = _ms(lambda: ts.planes(prof, True))
    over, t_over = _ms(lambda: ts.planes(prof, False, steps))
    del over
    ts._planes.pop((prof.name, None, False, steps), None)
    total = t_up + t_tab + t_fwd + t_rev + t_over
    print(f"preparation: staged set upload {t_up:.1f} ms "
          f"({data.numel() / t_up / 1e6:.2f} GB/s), tables {t_tab:.1f} ms, "
          f"forward planes {t_fwd:.1f} ms, reverse planes {t_rev:.1f} ms, "
          f"forward planes with {steps} overshoot steps {t_over:.1f} ms; "
          f"total {total:.1f} ms", flush=True)
    for reverse, s in ((False, 0), (True, 0), (False, steps)):
        width = aligned_words(ts.words(s) + 1)
        args = (data, *ts.tables(s), width, prof, reverse, s)
        ms = _kernel_ms(lambda: batch.pack_set(*args))
        bound = diagnostics.pack_bound(data.numel(), prof.planes,
                                       prof.eq_mode == "ascii", width)
        print(f"text set pack kernel, {'reverse' if reverse else 'forward'}"
              f", {s} steps: {ms:.3f} ms a launch, bound "
              f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}), "
              f"{bound['bound_ms'] / ms:.1%} of it", flush=True)
    again = TextSet(ts.texts, ts.device)
    tracemalloc.start()
    try:
        again.planes(prof, False)
        again.planes(prof, True)
        torch.cuda.synchronize()
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    del again
    print(f"preparation's host allocations (both strands, a second set): "
          f"peak {peak / 2**20:.1f} MiB for {data.numel() / 2**20:.1f} MiB "
          f"of texts", flush=True)


def _profiled(fn):
    """(wall ms, q2meta device ms, other device ms, kernel launches,
    key_averages) of one call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    dev = [e for e in avg if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]
    q2 = sum(e.self_device_time_total for e in dev
             if "scan_q_meta" in e.key) / 1e3
    total = sum(e.self_device_time_total for e in dev) / 1e3
    launches = sum(e.count for e in avg if "LaunchKernel" in e.key)
    return wall, q2, total - q2, launches, avg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sassy_tpu_torch.tools.profile_evals",
        description=__doc__.splitlines()[0])
    ap.add_argument("--bench", default="nanopore_full", choices=BENCHES)
    ap.add_argument("--out", type=Path, help="write the full tables")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_evals: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)

    cfg = bench_suite.load_config(args.bench)
    if args.bench.startswith("nanopore"):
        queries, texts = bench_suite.nanopore_data(cfg, 1.0)
        k = cfg["ks"][0]
    else:
        queries, text = bench_suite.off_target_data(cfg, 1.0)
        texts, k = [text], cfg["k"]
    n_bytes = sum(len(t) for t in texts)
    prof = Iupac()
    qcodes = [prof.encode(q) for q in queries]
    eng = BatchEngine("cuda")
    ts = TextSet(texts, eng.device)
    print(f"{args.bench}: {len(queries)} patterns x "
          f"{len(texts)} texts, {n_bytes} bytes, k={k}", flush=True)
    prepare(ts, prof)

    bounds = _plan(eng, prof, qcodes, ts, k)

    def tiling():
        return eng.candidates_many_flat(prof, qcodes, ts, k)

    n_search = min(len(qcodes), SEARCH_PATTERNS)

    def search():
        fins = [eng.candidates_many_flat_async(prof, [qc], ts, k)
                for qc in qcodes[:n_search]]
        return [fin() for fin in fins]

    tables = []
    for name, fn, scale in (("tiling", tiling, 1.0),
                            ("search", search, len(qcodes) / n_search)):
        fn()  # warm: the piece plan of this width
        torch.cuda.reset_peak_memory_stats()
        gathers = windows_plain.calls
        wall, q2, other, launches, avg = _profiled(fn)
        gathers = windows_plain.calls - gathers
        peak = torch.cuda.max_memory_allocated() / 2**30
        row = wall * scale  # the column's time for all the patterns
        print(f"{name}: {wall:.1f} ms (the row's call: {row:.1f} ms, "
              f"{n_bytes / row / 1e6:.3f} GB/s); device {q2 + other:.1f} ms "
              f"= q2meta {q2:.1f} + other ops {other:.1f}, busy "
              f"{(q2 + other) / wall:.1%}; {launches} kernel launches; "
              f"{gathers} window gathers; peak device memory {peak:.3f} GiB",
              flush=True)
        if name == "tiling":
            n_q2 = sum(e.count for e in avg if "scan_q_meta" in e.key
                       and e.device_type == DeviceType.CUDA)
            print(f"tiling: q2meta {n_q2} launches, {q2 / max(n_q2, 1):.3f} "
                  f"ms a launch; bound {sum(bounds):.1f} ms over "
                  f"{len(bounds)} chunks ({bounds[0]:.3f} ms the first), "
                  f"{sum(bounds) / q2:.1%} of it", flush=True)
        print(avg.table(sort_by="self_device_time_total", row_limit=12))
        tables.append(f"== {name}\n" + avg.table(
            sort_by="self_device_time_total", row_limit=-1))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(tables))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
