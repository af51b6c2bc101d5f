"""What the tools share: the device a tool runs on, the timing of one
callable and the spread of a list of times, the card's name and power
limit, the kernels' launch counts, and the registers ``ptxas`` reported
for a kernel of the built library."""

from __future__ import annotations

import re
import statistics
import subprocess
import sys
import time

from ..ops import myers_cuda

#: launches per timed batch, and batches after one warm-up launch
REPS = 10
BATCHES = 3


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def open_device(tool: str, device: str):
    """(``device`` as a torch.device, the card's line printed, or None on
    the CPU), or (None, None) after saying on stderr that ``tool`` found
    no CUDA device: a tool asked for the card never runs on the CPU in its
    place."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev, None
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device (pass --device cpu to run the plain "
              "versions on the CPU)", file=sys.stderr)
        return None, None
    card = card_line()
    print(card, flush=True)
    return dev, card


def launch_counts() -> dict:
    """The launch counts of the four kernels the searches run."""
    return {"q1meta": myers_cuda.scan_meta.launches,
            "q2meta": myers_cuda.scan_q_meta.launches,
            "q1": myers_cuda.scan.launches, "q2": myers_cuda.scan_q.launches}


def spread(times) -> dict:
    """Median, p10, p90 (nearest rank, as ``scripts/bench_oneshot.py``
    takes them) and best of a list of times."""
    t = sorted(times)
    return {"median": statistics.median(t),
            "p10": t[max(0, int(0.1 * len(t)) - 1)],
            "p90": t[min(len(t) - 1, int(0.9 * len(t)))], "best": t[0]}


def batch_ms(fn, device, reps: int = REPS, batches: int = BATCHES) -> list:
    """Milliseconds per call of ``fn`` in each of ``batches`` batches of
    ``reps`` calls (the batch's mean), after one warm-up call. CUDA events
    on the current stream of a CUDA device, the host clock on the CPU."""
    import torch

    on_card = torch.device(device).type == "cuda"
    fn()
    out = []
    for _ in range(batches):
        if on_card:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if on_card:
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / reps)
        else:
            out.append((time.perf_counter() - t0) * 1e3 / reps)
    return out


def time_ms(fn, device, reps: int = REPS, batches: int = BATCHES) -> float:
    """The least of ``batch_ms``: a batch that the host enqueued slowly,
    or that met the allocator's first growth, reads high."""
    return min(batch_ms(fn, device, reps, batches))


def kernel_resources(log: str) -> dict[str, tuple[int, int]]:
    """{mangled kernel name: (registers, spill bytes)} from the compiler's
    ``-Xptxas -v`` report, which names an entry function and then gives
    its spills and registers."""
    out: dict[str, tuple[int, int]] = {}
    name, spill = None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = (int(m.group(1)), spill)
            name = None
    return out


def built_resources() -> dict[str, tuple[int, int]]:
    """``kernel_resources`` of the built library's report ({} where there
    is no compiler, as on the CPU)."""
    if myers_cuda.nvcc_path() is None:
        return {}
    lib = myers_cuda.build()
    return kernel_resources(lib.with_name(lib.name + ".log").read_text())


def registers(resources: dict, kernel: str, *params: int) -> str:
    """"<registers>" (with "+<n>B spill" where it spills) of the
    instantiation ``kernel<params...>`` (integer and bool template
    parameters, as Itanium mangling spells them), "?" when the report
    lacks it."""
    want = kernel + "I" + "".join(
        f"L{'b' if isinstance(p, bool) else 'i'}{int(p)}E" for p in params
    ) + "E"
    for name, (regs, spill) in resources.items():
        if want in name:
            return f"{regs}" + (f"+{spill}B spill" if spill else "")
    return "?"
