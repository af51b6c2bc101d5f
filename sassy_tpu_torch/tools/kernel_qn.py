"""Time the kernel-design family of the pattern-batched scan on one GPU.

    python -m sassy_tpu_torch.tools.kernel_qn [--unroll] [--wunroll]
        [--shape nanopore|long|script] [--device cuda|cpu] [--seed 0]
        [--tiles N] [--words N] [--out FILE]

The counterpart of the reference's ``scripts/kernel_qn.py`` for the
H100: ``myers_cuda.scan_qn`` (``csrc/scan_qn.cu``) computes the q2 scan
with U patterns per thread, the row loop kept or fully unrolled, and WU
window words per loop iteration. Which of the three pays on this card is
what the tool measures:

- without a flag: U = 1, 2, 4, 8 with the row loop kept ("q1" .. "q8";
  "q1" is the one-pattern-per-thread batched scan, also run with the pure
  and the ascii eq);
- ``--unroll``: "q2-loop", "q2-unroll", "q1-unroll";
- ``--wunroll``: "q2-unroll-w1", "-w2", "-w4" and "q1-unroll-w2".

Every member is held bit for bit against the plain PyTorch version
(``scan_qn_plain``, computed once: every member computes the same
function) and against ``myers_cuda.scan_q`` (``csrc/scan_q.cu``, the
kernel the batched engine launches, timed first as the yardstick), then
timed with CUDA events: after one warm-up, the best of three batches of
10 launches (the mean of a batch). One line per member: name, ms,
(pattern row, window word) pairs per second, the registers ``ptxas`` gave
its kernel, and ``ok`` or ``MISMATCH``; a mismatch exits non-zero.

Shapes, from a numpy generator seeded with ``--seed``:

- ``nanopore`` (the default): the first dispatch chunk of 96 random 24 bp
  barcodes over random 10 kbp reads at k=3, as the batched engine cuts it
  (8,710 pieces of 321 words; the family runs the first 320, a multiple
  of every WU), with the iupac eq;
- ``long``: 8 random 64 bp patterns over the same reads (M = 64, the most
  rows the family's register carries hold);
- ``script``: the reference script's own inputs, random windows and masks
  (16 x 1024 tiles of 128 words, 8 patterns of 24 rows); ``--tiles`` and
  ``--words`` cut it, for runs on the CPU.

On ``--device cpu`` the wrappers run their plain versions (no kernel is
launched) and the times are the host's.
"""

from __future__ import annotations

import argparse
import sys

from .timing import built_resources, card_line, registers, time_ms

N_BARCODES = 96
BARCODE_LEN = 24
LONG_Q = 8
LONG_LEN = 64
READ_LEN = 10_000
#: more reads than one dispatch chunk of the 96 barcodes takes
N_READS = 9_000
K = 3
SCRIPT = {"tiles": 16 * 1024, "words": 128, "M": 24, "Q": 8}
#: the members each mode runs: (name, U, unroll, WU)
MODES = {
    "main": [("q1", 1, False, 1), ("q2", 2, False, 1), ("q4", 4, False, 1),
             ("q8", 8, False, 1)],
    "unroll": [("q2-loop", 2, False, 1), ("q2-unroll", 2, True, 1),
               ("q1-unroll", 1, True, 1)],
    "wunroll": [("q2-unroll-w1", 2, True, 1), ("q2-unroll-w2", 2, True, 2),
                ("q2-unroll-w4", 2, True, 4), ("q1-unroll-w2", 1, True, 2)],
}
EQ_INDEX = {"iupac": 0, "pure": 1, "ascii": 2}


def _t32(a, device):
    import numpy as np
    import torch

    return torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(device)


def script_inputs(rng, device, tiles: int, words: int) -> dict:
    """The reference script's inputs: random windows and row masks, no pad
    rows, every tile from the plain boundary."""
    import numpy as np
    import torch

    M, Q = SCRIPT["M"], SCRIPT["Q"]
    scal = torch.full((Q,), M, dtype=torch.int32, device=device)
    return {"iupac": (
        _t32(rng.integers(0, 2**31, (words, 4, tiles), dtype=np.int64),
             device),
        torch.zeros(tiles, dtype=torch.bool, device=device),
        _t32(rng.integers(0, 2**31, (Q, M, 4), dtype=np.int64), device),
        torch.zeros((Q, M), dtype=torch.int32, device=device),
        torch.ones((Q, M), dtype=torch.int32, device=device),
        scal, scal.clone(),
    )}


def read_inputs(rng, device, n_patterns: int, pattern_len: int,
                tiles: int | None, words: int | None) -> dict:
    """{eq: scan inputs} of the first dispatch chunk of ``n_patterns``
    random ACGT patterns over random reads, as ``BatchEngine`` cuts it:
    "iupac" and "pure" over the dna planes, "ascii" over the ascii
    planes. The windows keep a multiple of 4 words."""
    import numpy as np

    from .. import profiles
    from ..ops.batch import BatchEngine, TextSet

    n_reads = N_READS if tiles is None else max(1, tiles)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = acgt[rng.integers(0, 4, (n_reads, READ_LEN))]
    pats = acgt[rng.integers(0, 4, (n_patterns, pattern_len))]
    eng = BatchEngine(device)
    ts = TextSet(list(reads), device)
    out = {}
    for eq, prof in (("iupac", profiles.Dna()), ("ascii", profiles.Ascii())):
        (g,) = eng.groups(prof, [prof.encode(p) for p in pats], ts, K)
        pp = ts.piece_plan(g.halo, g.w_chars)
        q0, q1, t0, t1 = next(eng.chunks(g, pp))
        if tiles is not None:
            t1 = min(t1, t0 + tiles)
        win = ts.windows(prof, pp, False, t0, t1)
        nw = win.shape[0] // 4 * 4 if words is None else words
        win = win[:nw].contiguous()
        out[eq] = (win, pp.true_start[t0:t1].contiguous(), g.pmasks[q0:q1],
                   g.is_pad[q0:q1], g.h_init[q0:q1], g.m_real[q0:q1],
                   g.boundary_m[q0:q1])
    out["pure"] = out["iupac"]
    return out


def run(shape: str = "nanopore", modes=("main",), device="cuda", seed: int = 0,
        tiles: int | None = None, words: int | None = None,
        log=print) -> list[dict]:
    """Check and time the members of ``modes`` at ``shape``; one record
    per line printed: name, eq, U, unroll, WU, ms, pairs_per_s, registers,
    ok. Raises SystemExit after the last line if any member mismatched."""
    import numpy as np
    import torch

    from ..ops import myers_cuda
    from ..ops.myers_torch import Windows

    rng = np.random.default_rng(seed)
    if shape == "script":
        inputs = script_inputs(rng, device, tiles or SCRIPT["tiles"],
                               words or SCRIPT["words"])
    elif shape == "nanopore":
        inputs = read_inputs(rng, device, N_BARCODES, BARCODE_LEN, tiles,
                             words)
    elif shape == "long":
        inputs = read_inputs(rng, device, LONG_Q, LONG_LEN, tiles, words)
    else:
        raise ValueError(f"unknown shape {shape!r}")
    on_card = torch.device(device).type == "cuda"
    res = built_resources() if on_card else {}
    unit = "ms" if on_card else "cpu_ms"
    records = []

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def line(name, eq, fn, ref, yard, regs, member):
        args = inputs[eq]
        got = fn()
        sync()
        ok = all(torch.equal(a, b) for a, b in zip(got, ref)) and all(
            torch.equal(a, b) for a, b in zip(got, yard))
        del got
        ms = time_ms(fn, device)
        Q, M = args[2].shape[:2]
        NW, _, T = args[0].shape
        pairs = Q * M * NW * T / (ms * 1e-3)
        log(f"{name:14s} eq={eq:5s} {ms:9.3f} {unit}  {pairs / 1e12:7.3f} "
            f"T(row, word)/s  regs {regs:>4s}  {'ok' if ok else 'MISMATCH'}")
        records.append({"name": name, "eq": eq, "U": member[0],
                        "unroll": member[1], "WU": member[2], unit: ms,
                        "pairs_per_s": pairs, "registers": regs, "ok": ok})

    done = set()
    for eq in ("iupac", "pure", "ascii"):
        # the other eqs only for "q1", the one member built for them
        members = [m for mode in modes for m in MODES[mode]
                   if eq == "iupac" or m[1:] == (1, False, 1)]
        if eq not in inputs or not members:
            continue
        args = inputs[eq]
        Q, M = args[2].shape[:2]
        NW, P, T = args[0].shape
        log(f"shape {shape}: eq={eq} Q={Q} M={M} NW={NW} P={P} T={T}")
        ref = myers_cuda.scan_qn_plain(*args, eq)
        # the yardstick q2 reads the descriptor of the same windows
        q2_args = (Windows.of(args[0]), *args[1:])
        yard = myers_cuda.scan_q(*q2_args, eq)
        sync()
        line("scan_q", eq, lambda: myers_cuda.scan_q(*q2_args, eq), ref, yard,
             registers(res, "scan_q_kernel", EQ_INDEX[eq], True), (1, False, 1))
        for name, U, unroll, WU in members:
            if (eq, U, unroll, WU) in done:
                continue
            done.add((eq, U, unroll, WU))
            if Q % U or NW % WU:
                log(f"{name:14s} eq={eq:5s} skipped: Q={Q} or NW={NW} does "
                    f"not split into U={U}, WU={WU}")
                continue
            if on_card and not myers_cuda.qn_member_built(eq, M, U, unroll,
                                                          WU):
                log(f"{name:14s} eq={eq:5s} skipped: not built for M={M}")
                continue
            line(name, eq,
                 lambda: myers_cuda.scan_qn(*args, eq, U, unroll, WU), ref,
                 yard, registers(res, "scan_qn_kernel", EQ_INDEX[eq], U,
                                 M if unroll else 0, WU), (U, unroll, WU))
        del ref, yard
    if not all(r["ok"] for r in records):
        raise SystemExit("kernel_qn: a member differs from its plain "
                         "version or from scan_q")
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--unroll", action="store_true")
    ap.add_argument("--wunroll", action="store_true")
    ap.add_argument("--shape", default="nanopore",
                    choices=("nanopore", "long", "script"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiles", type=int)
    ap.add_argument("--words", type=int)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    import torch

    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("kernel_qn: no CUDA device", file=sys.stderr)
        return 2
    lines = []

    def log(msg):
        print(msg, flush=True)
        lines.append(msg)

    if dev.type == "cuda":
        log(card_line())
    modes = [m for m, on in (("unroll", a.unroll), ("wunroll", a.wunroll))
             if on] or ["main"]
    try:
        run(a.shape, modes, a.device, a.seed, a.tiles, a.words, log)
    finally:
        if a.out:
            with open(a.out, "a") as f:
                f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
