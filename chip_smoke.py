#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sassy_tpu_torch) on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an sm_90a GPU (H100) and
the CUDA toolkit. Phases:

1. the card (nvidia-smi), the toolchain (features()), and the build of
   the scan kernel from sassy_tpu_torch/csrc/ with nvcc;
2. kernel vs plain: the q1meta scan kernel against its plain PyTorch
   version on the windows of a 1 GiB text (the H100 tile plan, a 23 bp
   pattern at k=3), bit for bit on all five outputs, for the pure, iupac
   and ascii eq and for a 100 bp pattern (M > 64); both timed;
3. end to end at full size: Searcher("dna", rc=True, device="cuda")
   .search over 1 GiB of random ACGT with mutated copies of the pattern
   planted on both strands; every copy must come back, through the
   kernel, with the cost and CIGAR of its one planted substitution; the
   phases of one strand are timed;
4. end to end, the card against the port's CPU path (the plain version
   of the kernel) on a 50 kbp slice: search and search_all at k in
   {0, 1, 3}, Match for Match with CIGAR. The CPU path is held to the
   numpy oracle by tests/test_torch_search.py, and the card to it by
   tests/test_torch_cuda.py.

The script imports neither JAX nor the reference package's engines.

Progress goes to stdout. The line before the last is the kernels' JSON
record; the last line is {"ok": true, "device": {...}}. Any failure exits
non-zero without that line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

DEVICE = "cuda"
SEED = 0
N_TEXT = 1 << 30
K = 3
PATTERN_LEN = 23
LONG_PATTERN_LEN = 100
SLICE = 50_000
REPS = 10
#: the planted copies' one edit: a substitution at this pattern index
MUT_AT = 11


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
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


def random_acgt(gen, n: int):
    import torch

    bases = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=DEVICE)
    return bases[torch.randint(0, 4, (n,), generator=gen, device=DEVICE)]


def kernel_vs_plain(gen, text_dev):
    """Phase 2. Returns the headline (pure) record: times and error."""
    import torch

    from sassy_tpu_torch import profiles
    from sassy_tpu_torch.ops import myers_cuda
    from sassy_tpu_torch.ops.myers_torch import TorchEngine

    eng = TorchEngine(DEVICE)
    dna = profiles.Dna()
    pattern = random_acgt(gen, PATTERN_LEN).cpu().numpy()
    long_pattern = random_acgt(gen, LONG_PATTERN_LEN).cpu().numpy()
    t0 = time.perf_counter()
    prep = eng.prepare(dna, text_dev)
    prep_ascii = eng.prepare(profiles.Ascii(), text_dev)
    torch.cuda.synchronize()
    log(f"phase 2: packed {N_TEXT >> 20} MiB for dna and ascii in "
        f"{time.perf_counter() - t0:.3f} s")
    cases = [
        ("pure", dna, prep, pattern),
        ("iupac", dna, prep, pattern),
        ("ascii", profiles.Ascii(), prep_ascii, pattern),
        ("pure, M>64", dna, prep, long_pattern),
    ]
    head = None
    for label, prof, p, pat in cases:
        inp = eng.build_inputs(prof, prof.encode(pat), p, K)
        if label == "iupac":
            inp.eq_mode = "iupac"
        args = (inp.windows, inp.tile0, inp.valid_from, inp.valid_to,
                inp.pmasks, inp.is_pad, inp.h_init, inp.m_real,
                inp.boundary_m, inp.k, inp.eq_mode)
        got = myers_cuda.scan_meta(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = myers_cuda.scan_meta_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(
            (a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
            for a, b in zip(got, ref)
        )
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        ms = cuda_ms(lambda: myers_cuda.scan_meta(*args), REPS)
        NW, P, T = inp.windows.shape
        log(f"phase 2: {label}: eq={inp.eq_mode} M={inp.pmasks.shape[0]} "
            f"NW={NW} P={P} T={T} kernel {ms:.3f} ms, plain {plain_ms:.1f} ms,"
            f" bit-equal={same} max_abs_err={err}")
        if not same:
            fail(f"kernel != plain for {label}")
        if head is None:
            head = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
        del got, ref
    return head


def plant(text, pattern, rc_pattern, n: int):
    """Mutated copies (one substitution, as bench.py plants them) on both
    strands at fixed offsets. Returns [(strand, start)]."""
    mutated = pattern.copy()
    mutated[MUT_AT] = ord("A") if mutated[MUT_AT] != ord("A") else ord("C")
    rc_mut = rc_pattern(mutated)
    sites = [("FWD", 12345, mutated), ("FWD", n // 2, mutated),
             ("RC", n // 3, rc_mut), ("RC", n - 5000, rc_mut)]
    for _, off, seq in sites:
        text[off : off + len(seq)] = seq
    return [(s, off) for s, off, _ in sites]


def end_to_end(gen):
    """Phase 3. Returns the kernel's launch count in the main-path run."""
    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher, Strand, profiles
    from sassy_tpu_torch.ops import myers_cuda

    dna = profiles.Dna()
    pattern = random_acgt(gen, PATTERN_LEN).cpu().numpy()
    text = random_acgt(gen, N_TEXT).cpu().numpy()
    rc = lambda s: np.frombuffer(dna.reverse_complement(s), np.uint8)  # noqa: E731
    sites = plant(text, pattern, rc, N_TEXT)
    searcher = Searcher("dna", rc=True, device=DEVICE)
    eng = searcher.engine
    pcodes = dna.encode(pattern)

    # the phases of the forward strand, each ended by a synchronise; the
    # first run pays one-time costs (allocator growth, first launches)
    names = ("upload+pack", "windows", "scan kernel", "selection",
             "traceback")
    for run in ("cold", "warm"):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        prep = eng.prepare(dna, text)
        mark()
        inp = eng.build_inputs(dna, pcodes, prep, K)
        mark()
        outs = eng.scan(inp)
        mark()
        cands = eng.select(inp, outs).cpu()
        mark()
        ends = sorted(zip(*cands.tolist()))
        searcher._postprocess(pattern, pcodes, text, K, ends, None,
                              Strand.FWD, 0, 0)
        mark()
        log(f"phase 3: forward strand, {N_TEXT >> 20} MiB, {run}: "
            + ", ".join(f"{nm} {(b - a) * 1e3:.1f} ms"
                        for nm, a, b in zip(names, marks, marks[1:]))
            + f" ({len(ends)} candidates)")
        del prep, inp, outs

    myers_cuda.scan_meta.launches = 0
    t0 = time.perf_counter()
    matches = searcher.search(pattern, text, K)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = myers_cuda.scan_meta.launches
    log(f"phase 3: Searcher.search, both strands, {N_TEXT >> 20} MiB: "
        f"{e2e:.3f} s, "
        f"{len(matches)} matches, scan kernel launches {launches}")
    if launches < 2:
        fail(f"the search launched the scan kernel {launches} times")

    # each planted copy, aligned as it was planted: one substitution
    m = PATTERN_LEN
    want_cigar = f"{MUT_AT}=1X{m - MUT_AT - 1}="
    for strand, off in sites:
        got = [x for x in matches
               if x.text_start == off and x.strand.name == strand]
        if len(got) != 1:
            fail(f"planted {strand} copy at {off}: got {got}")
        g = got[0]
        if (g.text_end != off + m or g.cost != 1
                or g.cigar.to_string() != want_cigar):
            fail(f"planted {strand} copy at {off}: {g}, want cost 1, "
                 f"cigar {want_cigar}")
        log(f"phase 3: planted {strand} copy at {off}: found, cost {g.cost}, "
            f"cigar {g.cigar.to_string()}")
    return launches, text, pattern


def against_cpu(text, pattern):
    """Phase 4: the port on the card equals its CPU path."""
    from sassy_tpu_torch import Searcher, profiles

    mid = len(text) // 2
    piece = text[mid - SLICE // 2 : mid + SLICE // 2].copy()
    # exact copies on both strands, beside the mutated one at the middle
    rc = profiles.Dna().reverse_complement(pattern)
    piece[1000 : 1000 + len(pattern)] = pattern
    piece[3000 : 3000 + len(pattern)] = list(rc)
    port = Searcher("dna", rc=True, device=DEVICE)
    plain = Searcher("dna", rc=True, device="cpu")
    for k in (0, 1, 3):
        for fn in ("search", "search_all"):
            got = getattr(port, fn)(pattern, piece, k)
            want = getattr(plain, fn)(pattern, piece, k)
            same = bool(want) and len(got) == len(want) and all(
                a.same_as(b) and a.cigar.to_string() == b.cigar.to_string()
                for a, b in zip(got, want)
            )
            log(f"phase 4: {fn} k={k}: {len(got)} matches, equal={same}")
            if not same:
                fail(f"{fn} k={k} differs from the CPU path")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import sassy_tpu_torch
    from sassy_tpu_torch.ops import myers_cuda

    log(card_line())
    log(f"features: {json.dumps(sassy_tpu_torch.features())}")
    t0 = time.perf_counter()
    lib = myers_cuda.build()
    log(f"phase 1: built {lib.name} in {time.perf_counter() - t0:.1f} s")
    log(lib.with_name(lib.name + ".log").read_text().strip())

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    text_dev = random_acgt(gen, N_TEXT)
    head = kernel_vs_plain(gen, text_dev)
    del text_dev
    torch.cuda.empty_cache()

    launches, text, pattern = end_to_end(gen)
    against_cpu(text, pattern)
    engines = [m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "sassy_tpu.ops.myers", "sassy_tpu.ops.minima",
         "sassy_tpu.ops.batch", "sassy_tpu.parallel"))]
    if engines:
        fail(f"JAX or the reference engines were imported: {engines}")

    record = {"kernels": [{
        "name": "scan_meta (q1meta)",
        "route": "cuda",
        "source": "sassy_tpu_torch/csrc/scan_meta.cu",
        "replaces": "sassy_tpu/ops/myers_pallas.py:201",
        "launches": launches,
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
    }]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
