"""Where one strand's time goes in the single-pattern search on a GPU.

    python -m sassy_tpu_torch.tools.profile_path [--mib 1024] [--out FILE]

The shape is chip_smoke.py's: a 23 bp pattern at k=3 over random ACGT
(1 GiB by default), made from ``--seed``. Prints the card's name and power
limit, then, for each phase of one strand, the host-clock time of a cold
first call and the mean of ``--reps`` warm calls, each ended by a
synchronise:

- upload: the host-to-device copy of the text bytes (``_upload``: two
  pinned staging buffers, the host copy of one chunk overlapping the
  transfer of the other);
- pack: bytes on the device -> bit-planes (``PreparedText``: the pack
  kernel);
- descriptors: the tile plan and each tile's window descriptor
  (``PreparedText.windows``: its first plane word and the end of the
  words it may read, 16 bytes a tile; the kernel reads the windows from
  the planes, so no window copy is built);
- scan: the q1meta kernel;
- selection: the state chain, the screened-word expansion and the one
  device-to-host copy of the candidates.

Then the upload in ``UPLOAD_TURNS`` turns against a pageable copy
(``torch.from_numpy(a).to(device)``, one PyTorch call): pageable,
staged, staged, pageable, ..., each ended by a synchronise; every time
and the medians.

Then the host split of one warm ``candidates`` call on the prepared text
(the call ``tools.bench`` times, here on this tool's text): the median,
p10 and p90 of ``SPLIT_CALLS`` calls of each of its steps, run as its
dispatch thread runs them but each ended by a synchronise (inputs, scan,
select, copy, host: ``tolist`` and the sort), of the whole call, and of
what the steps leave of it (the dispatch thread's hand-off and the waits
the synchronises moved).

Then the device memory the prepared text and one search's inputs hold
(``torch.cuda.memory_allocated`` before and after, the planes and the
descriptors; before the descriptors the window tensor too).

Then one warm strand (pack from the device text, descriptors, scan,
selection) under ``torch.profiler``: its device time per op (top 25 by self device
time), the sum of device time against the wall time (the device's busy
share) and the number of kernel launches. ``--out`` writes the whole table.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from pathlib import Path

import torch

PATTERN_LEN = 23
K = 3
SPLIT_CALLS = 20
#: turns of the staged upload against the pageable one
UPLOAD_TURNS = 5


def _timed(fn, reps: int):
    """(cold ms, mean warm ms) of ``fn``, each call ended by a synchronise."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times[0], sum(times[1:]) / reps


def split_call(eng, profile, codes, text, k: int, sync,
               calls: int = SPLIT_CALLS) -> dict:
    """{step: {median, p10, p90, best} in ms} of ``calls`` warm
    ``candidates`` calls of ``eng`` on ``text`` (prepared), split into the
    steps its dispatch thread runs (the 23 bp shape runs no suffix
    prefilter), each ended by ``sync``; then ``call``, the whole
    ``candidates``, and ``rest``, its median less the steps' medians."""
    from .timing import spread

    names = ("inputs", "scan", "select", "copy", "host", "call")
    times = {name: [] for name in names}
    for _ in range(calls):
        t = [time.perf_counter()]
        inp = eng.build_inputs(profile, codes, text, k)
        sync()
        t.append(time.perf_counter())
        outs = eng.scan(inp)
        sync()
        t.append(time.perf_counter())
        sel = eng.select(inp, outs)
        sync()
        t.append(time.perf_counter())
        host = sel.cpu()
        t.append(time.perf_counter())
        pos, cost = host.tolist()
        sorted(zip(pos, cost))
        t.append(time.perf_counter())
        eng.candidates(profile, codes, text, k, None, None, False)
        t.append(time.perf_counter())
        for name, t0, t1 in zip(names, t, t[1:]):
            times[name].append((t1 - t0) * 1e3)
    out = {name: spread(v) for name, v in times.items()}
    out["rest"] = {"median": out["call"]["median"] - sum(
        out[name]["median"] for name in names[:-1])}
    return out


def upload_turns(text, dev, turns: int = UPLOAD_TURNS) -> dict:
    """{"pageable": ms, "staged": ms} lists of ``turns`` uploads each of
    the host array ``text``, in turns (pageable, staged, staged,
    pageable, ...), each ended by a synchronise."""
    from sassy_tpu_torch.ops.myers_torch import _upload

    ways = {"pageable": lambda: torch.from_numpy(text).to(dev),
            "staged": lambda: _upload(text, dev)}
    out = {name: [] for name in ways}
    for i in range(2 * turns):
        name = ("pageable", "staged")[(i + i // 2) % 2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ways[name]()
        torch.cuda.synchronize()
        out[name].append((time.perf_counter() - t0) * 1e3)
        del got
    return out


def print_turns(turns: dict, n_bytes: int) -> None:
    for name, times in turns.items():
        med = sorted(times)[len(times) // 2]
        print(f"upload turns, {name}: "
              + ", ".join(f"{t:.3f}" for t in times)
              + f" ms (median {med:.3f}, {n_bytes / med / 1e6:.2f} GB/s)",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=1024, help="text size, MiB")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, help="write the full profile table")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_path: needs a CUDA device")

    from sassy_tpu_torch import profiles
    from sassy_tpu_torch.ops.myers_torch import TorchEngine, _upload

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    dev = torch.device("cuda")
    n = args.mib << 20
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bases = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    text_dev = bases[torch.randint(0, 4, (n,), generator=gen, device=dev)]
    text = text_dev.cpu().numpy()
    dna = profiles.Dna()
    codes = dna.encode(text[n // 2 : n // 2 + PATTERN_LEN].copy())
    eng = TorchEngine(dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    prep = eng.prepare(dna, text_dev)
    inp = eng.build_inputs(dna, codes, prep, K)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev) - before
    print(f"prepared text and inputs: {held / 2**30:.4f} GiB of device "
          f"memory (planes {prep.planes.numel() * 4 / 2**30:.4f} GiB)",
          flush=True)
    outs = eng.scan(inp)

    def descriptors():
        prep._descs.clear()  # drop the cached plan: describe it anew
        eng.build_inputs(dna, codes, prep, K)

    phases = {
        "upload": lambda: _upload(text, dev),
        "pack": lambda: eng.prepare(dna, text_dev),
        "descriptors": descriptors,
        "scan": lambda: eng.scan(inp),
        "selection": lambda: eng.select(inp, outs).cpu(),
    }
    NW, P, T = inp.windows.shape
    print(f"{args.mib} MiB, M={inp.pmasks.shape[0]} k={K} eq={inp.eq_mode} "
          f"NW={NW} P={P} T={T}")
    for name, fn in phases.items():
        cold, warm = _timed(fn, args.reps)
        print(f"{name}: cold {cold:.3f} ms, warm {warm:.3f} ms "
              f"(mean of {args.reps})", flush=True)
    print_turns(upload_turns(text, dev), n)
    split = split_call(eng, dna, codes, prep, K, torch.cuda.synchronize)
    for name, sp in split.items():
        print(f"candidates split, {name}: median {sp['median']:.3f} ms"
              + (f" (p10 {sp['p10']:.3f}, p90 {sp['p90']:.3f})"
                 if "p10" in sp else "") + f" of {SPLIT_CALLS} calls",
              flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    del prep, inp, outs
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p = eng.prepare(dna, text_dev)
        i = eng.build_inputs(dna, codes, p, K)
        eng.select(i, eng.scan(i)).cpu()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    # the device's own events: the aten ops that launched them repeat them
    device_ms = sum(e.self_device_time_total for e in avg
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation) / 1e3
    launches = sum(e.count for e in avg if "LaunchKernel" in e.key)
    print(f"profiled strand: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms "
          f"(busy {device_ms / wall_ms:.1%}), {launches} kernel launches")
    print(avg.table(sort_by="self_device_time_total", row_limit=25))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(avg.table(sort_by="self_device_time_total",
                                      row_limit=-1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
