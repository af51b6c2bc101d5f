"""Where one strand's time goes in the single-pattern search on a GPU.

    python -m sassy_tpu_torch.tools.profile_path [--mib 1024] [--out FILE]

The shape is chip_smoke.py's: a 23 bp pattern at k=3 over random ACGT
(1 GiB by default), made from ``--seed``. Prints the card's name and power
limit, then, for each phase of one strand, the host-clock time of a cold
first call and the mean of ``--reps`` warm calls, each ended by a
synchronise:

- upload: the pageable host-to-device copy of the text bytes;
- pack: bytes on the device -> bit-planes (``PreparedText``);
- windows: the (NW, P, T) halo tiles (``build_windows``);
- scan: the q1meta kernel;
- selection: the state chain, the screened-word expansion and the one
  device-to-host copy of the candidates.

Then one warm strand (pack from the device text, windows, scan, selection)
under ``torch.profiler``: its device time per op (top 25 by self device
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
    prep = eng.prepare(dna, text_dev)
    inp = eng.build_inputs(dna, codes, prep, K)
    outs = eng.scan(inp)

    def windows():
        prep._wins.clear()  # drop the cached plan: build the windows anew
        eng.build_inputs(dna, codes, prep, K)

    phases = {
        "upload": lambda: _upload(text, dev),
        "pack": lambda: eng.prepare(dna, text_dev),
        "windows": windows,
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
