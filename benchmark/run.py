"""Run one cell of the benchmark of sassy_tpu_torch on this machine's card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

One process: it makes the cell's inputs from the seed, warms the program
up on them (set-up), drives the cell's closed loop for ``--seconds``, then
holds the Match lists of calls drawn from the seed to the plain reference
in ``benchmark/reference/``. The last line on standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (with ``--trace
0`` the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones,
read under ``torch.profiler``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
also the last lines on standard error. Without a CUDA card, or with fewer
than the cell asks for, it prints no result and exits non-zero; so it does
where the port's package is not in this checkout, and where JAX or the
JAX package was loaded.

``--control <name>`` puts a control (``benchmark/controls.py``) in the
program's place: its runs have to come out not correct.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from . import spec  # noqa: E402

__all__ = ["main", "run_cell", "FORBIDDEN"]

#: top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "sassy_tpu")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """The forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", searcher_factory=None,
             t_start: float | None = None) -> dict:
    """One run of ``cell``; returns the result line's object.
    ``searcher_factory(config, device)``: what stands in the program's
    place (default ``controls.program``)."""
    import torch

    from . import check, client, controls, inputs, trace as trace_mod

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    config, traffic = cell.config, cell.traffic
    if on_card:
        torch.cuda.init()
    t_ctx = time.perf_counter()
    data = inputs.make_inputs(config, traffic, seed, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_data = time.perf_counter()
    searcher = (searcher_factory or controls.program)(config, device)
    warm = client.run_loop(searcher, data, config, traffic,
                           max_calls=traffic["warmup_calls"])
    errors = [c.error for c in warm if c.error]
    if errors:
        raise RuntimeError(f"the warm-up failed:\n{errors[0]}")
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (imports and context "
        f"{t_ctx - t_start:.3f}, inputs {t_data - t_ctx:.3f}, warm-up "
        f"{t_start + setup_s - t_data:.3f}): {len(data.lengths)} texts, "
        f"{int(data.lengths.sum())} bases, {len(data.patterns)} patterns, "
        f"{len(data.plants)} plants")

    sampler = check.Sampler(cell.check["sampled_calls"], seed,
                            lambda c: data.lengths[data.calls[c.batch]])
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.start()
        with record_function("window"), client.GcWatch() as gcw:
            calls = client.run_loop(searcher, data, config, traffic,
                                    seconds=seconds, labels=True,
                                    on_done=sampler)
            if on_card:
                torch.cuda.synchronize()
        prof.stop()
    else:
        with client.GcWatch() as gcw:
            calls = client.run_loop(searcher, data, config, traffic,
                                    seconds=seconds, on_done=sampler)
    window_s = calls[-1].done - calls[0].submit
    peak = torch.cuda.max_memory_allocated() if on_card else None
    _log_window(calls, window_s, gcw)
    for c in calls:
        if c.error:
            log(f"call {c.index} failed:\n{c.error}")
            break

    td = None
    if prof is not None:
        t0 = time.perf_counter()
        td = trace_mod.from_profiler(prof)
        td.host.extend(("gc", s, e) for s, e in gcw.spans)
        del prof
        log(f"trace read in {time.perf_counter() - t0:.1f} s: "
            f"{len(td.device)} device operations")
    del searcher, warm
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = check.run_checks(data, config, cell.check, sampler, calls, seed,
                              device, log=log)

    ctx = client.RunContext(
        cell=cell.name, calls=calls, window_s=window_s, setup_s=setup_s,
        peak_bytes=peak, pattern_lengths=[len(p) for p in data.patterns],
        strands=2 if config["rc"] else 1, trace=td)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": peak or 0}
    result = {"correct": check.passed(checks), "attempted": len(calls),
              "failed": sum(c.error is not None for c in calls),
              "metrics": metrics, "device": dev}
    if td is not None:
        dev["busy_s"] = td.busy_s()
        dev["window_s"] = td.window_s
        result["breakdown"] = trace_mod.breakdown(td)
    result["checks"] = checks
    return result


def _log_window(calls, window_s: float, gcw) -> None:
    """The window's calls, latencies, host steps and collector passes."""
    n = len(calls)
    lat = sorted(c.done - c.submit for c in calls)
    sub = [c.submitted - c.submit for c in calls]
    keys = ("filters", "trace", "build", "unpack", "cigars", "match_objects")
    fin = {k: sum(c.split.get(k, 0.0) for c in calls) / n * 1e3 for k in keys}
    gens = [sum(g == x for g, _, _ in gcw.passes) for x in range(3)]
    log(f"window {window_s:.3f} s: {n} calls, "
        f"{sum(c.bases for c in calls)} bases, "
        f"{sum(c.matches for c in calls) / n:.0f} matches a call; latency "
        f"p50 {lat[n // 2] * 1e3:.1f} ms, p95 {lat[int(0.95 * (n - 1))] * 1e3:.1f}"
        f", max {lat[-1] * 1e3:.1f}; submit mean {sum(sub) / n * 1e3:.1f} ms,"
        f" max {max(sub) * 1e3:.1f}; finish split means (ms) "
        + ", ".join(f"{k} {v:.1f}" for k, v in fin.items())
        + "; collector passes by generation "
        f"{gens}, {sum(e - s for _, s, e in gcw.passes):.3f} s")


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    from .controls import CONTROLS

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=sorted(CONTROLS),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    # every build and kernel cache in fixed directories of the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(spec.ROOT / "build" / "benchmark" / sub)
    try:
        cell = spec.load_cell(args.workload)
    except (KeyError, OSError, ValueError) as e:
        log(f"no such cell: {e}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"the cell needs {cell.chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        import sassy_tpu_torch
    except ImportError as e:
        log(f"the port's package is missing: {e}")
        return 4
    if Path(sassy_tpu_torch.__file__).resolve().parents[1] != spec.ROOT:
        log(f"sassy_tpu_torch is not this checkout's: {sassy_tpu_torch.__file__}")
        return 4
    factory = CONTROLS[args.control] if args.control else None
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", factory, T_START)
    found = forbidden_modules()
    if found:
        log(f"loaded in this process, and not allowed: {', '.join(found)}")
        return 5
    log(_card_line())
    for name, c in result["checks"].items():
        rule = ">=" if c.get("at_least") else "<="
        log(f"check {name}: {c['value']} (limit {rule} {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
