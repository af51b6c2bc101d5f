"""What the kernel-design tools share: the timing of one callable, the
card's name and power limit, and the registers ``ptxas`` reported for a
kernel of the built library."""

from __future__ import annotations

import re
import subprocess
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


def time_ms(fn, device, reps: int = REPS, batches: int = BATCHES) -> float:
    """Milliseconds per call of ``fn``: after one warm-up call, the least
    mean over ``batches`` batches of ``reps`` calls each (a batch that the
    host enqueued slowly, or that met the allocator's first growth, reads
    high). CUDA events on the current stream of a CUDA device, the host
    clock on the CPU."""
    import torch

    on_card = torch.device(device).type == "cuda"
    fn()
    best = float("inf")
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
            best = min(best, start.elapsed_time(end) / reps)
        else:
            best = min(best, (time.perf_counter() - t0) * 1e3 / reps)
    return best


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
