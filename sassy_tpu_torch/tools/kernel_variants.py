"""Where the time of the scan's row step goes on one GPU, by ablation.

    python -m sassy_tpu_torch.tools.kernel_variants
        [--shape single|script] [--mib 1024] [--device cuda|cpu] [--seed 0]
        [--tiles N] [--words N] [--out FILE]

The counterpart of the reference's ``scripts/kernel_variants.py`` for the
H100: ``myers_cuda.scan_variant`` (``csrc/scan_variants.cu``) runs one
pattern's row loop as ``full`` (the step the scan kernels run), ``noeq``
(eq is plane 0's word), ``nomem`` (no row carries) and ``nostore`` (no vp
stores, one popcount sum per tile). The differences between their times
say what the eq, the carries and the stores cost.

Every variant is held bit for bit against its plain PyTorch version
(``scan_variant_plain``), and ``full``'s vp against that of
``myers_cuda.scan`` (``csrc/scan.cu``, timed first as the yardstick) for
the same pattern, then timed with CUDA events: after one warm-up, the
best of three batches of 10 launches (the mean of a batch). One line per
variant: name, ms, (pattern row, window word)
pairs per second, the registers ``ptxas`` gave its kernel, and ``ok`` or
``MISMATCH``; a mismatch exits non-zero.

Shapes, from a numpy generator seeded with ``--seed``:

- ``single`` (the default): the windows of ``--mib`` MiB of random ACGT
  under the single engine's tile plan for a 24 bp pattern at k=3, with
  the pattern's iupac row masks;
- ``script``: the reference script's own inputs, random windows and
  all-or-nothing row masks (64 x 1024 tiles of 130 words, 24 rows);
  ``--tiles`` and ``--words`` cut it, for runs on the CPU.

On ``--device cpu`` the wrappers run their plain versions (no kernel is
launched) and the times are the host's.
"""

from __future__ import annotations

import argparse
import sys

from .timing import built_resources, card_line, registers, time_ms

PATTERN_LEN = 24
K = 3
SCRIPT = {"tiles": 64 * 1024, "words": 130, "M": 24}


def script_inputs(rng, device, tiles: int, words: int):
    import numpy as np
    import torch

    def t32(a):
        return torch.from_numpy(a.astype(np.int32)).to(device)

    win = t32(rng.integers(0, 2**31, (words, 4, tiles), dtype=np.int64))
    return win, t32(rng.integers(-1, 1, (SCRIPT["M"], 4), dtype=np.int64))


def single_inputs(rng, device, mib: int, tiles: int | None,
                  words: int | None):
    """The windows and iupac row masks of a 24 bp pattern over ``mib`` MiB
    of random ACGT, as the single engine plans them."""
    import numpy as np

    from .. import profiles
    from ..ops.myers_torch import TorchEngine

    acgt = np.frombuffer(b"ACGT", np.uint8)
    text = acgt[rng.integers(0, 4, mib << 20, dtype=np.uint8)]
    pattern = acgt[rng.integers(0, 4, PATTERN_LEN)]
    dna = profiles.Dna()
    inp = TorchEngine(device).build_inputs(dna, dna.encode(pattern), text, K)
    win = inp.windows
    if tiles is not None or words is not None:
        win = win[: words or win.shape[0], :, : tiles or win.shape[2]]
        win = win.contiguous()
    # the pattern's real rows: the ablations take no pad rows
    return win, inp.pmasks[inp.pmasks.shape[0] - inp.m_real :].contiguous()


def run(shape: str = "single", device="cuda", seed: int = 0, mib: int = 1024,
        tiles: int | None = None, words: int | None = None,
        log=print) -> list[dict]:
    """Check and time the four variants at ``shape``; one record per line
    printed: name, ms, pairs_per_s, registers, ok. Raises SystemExit after
    the last line if any variant mismatched."""
    import numpy as np
    import torch

    from ..ops import myers_cuda

    rng = np.random.default_rng(seed)
    if shape == "script":
        win, pm = script_inputs(rng, device, tiles or SCRIPT["tiles"],
                                words or SCRIPT["words"])
    elif shape == "single":
        win, pm = single_inputs(rng, device, mib, tiles, words)
    else:
        raise ValueError(f"unknown shape {shape!r}")
    on_card = torch.device(device).type == "cuda"
    res = built_resources() if on_card else {}
    unit = "ms" if on_card else "cpu_ms"
    NW, P, T = win.shape
    M = pm.shape[0]
    log(f"shape {shape}: M={M} NW={NW} P={P} T={T}")
    records = []

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def line(name, fn, ok, regs):
        ms = time_ms(fn, device)
        pairs = M * NW * T / (ms * 1e-3)
        log(f"{name:8s} {ms:9.3f} {unit}  {pairs / 1e12:7.3f} T(row, word)/s"
            f"  regs {regs:>4s}  {'ok' if ok else 'MISMATCH'}")
        records.append({"name": name, unit: ms, "pairs_per_s": pairs,
                        "registers": regs, "ok": ok})

    # the yardstick: q1 for the same pattern from the plain boundary
    zeros = torch.zeros(M, dtype=torch.int32, device=device)
    q1_args = (win, torch.zeros(T, dtype=torch.bool, device=device), pm,
               zeros, torch.ones_like(zeros), M, M, "iupac")
    vp_q1 = myers_cuda.scan(*q1_args)[0]
    sync()
    line("scan", lambda: myers_cuda.scan(*q1_args), True,
         registers(res, "scan_kernel", 0, True))
    for v, index in myers_cuda.VARIANTS.items():
        got = myers_cuda.scan_variant(win, pm, v)
        sync()
        ok = torch.equal(got, myers_cuda.scan_variant_plain(win, pm, v))
        if v == "full":
            ok = ok and torch.equal(got, vp_q1)
        del got
        line(v, lambda: myers_cuda.scan_variant(win, pm, v), ok,
             registers(res, "scan_variant_kernel", index))
    if not all(r["ok"] for r in records):
        raise SystemExit("kernel_variants: a variant differs from its plain "
                         "version")
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="single", choices=("single", "script"))
    ap.add_argument("--mib", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiles", type=int)
    ap.add_argument("--words", type=int)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    import torch

    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    lines = []

    def log(msg):
        print(msg, flush=True)
        lines.append(msg)

    if dev.type == "cuda":
        log(card_line())
    try:
        run(a.shape, a.device, a.seed, a.mib, a.tiles, a.words, log)
    finally:
        if a.out:
            with open(a.out, "a") as f:
                f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
