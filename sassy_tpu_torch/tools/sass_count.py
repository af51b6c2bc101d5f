"""Count the instructions of the scan kernels' row loop in the compiled SASS.

    python -m sassy_tpu_torch.tools.sass_count [--sass FILE] [--dump FILE]
        [--out FILE]

Without ``--sass`` it builds the kernel library (``myers_cuda.build``) and
disassembles it with ``cuobjdump -sass`` (``--dump`` keeps that text);
with ``--sass`` it reads a saved disassembly instead. For every kernel
function it finds the innermost loops (a branch back to an earlier
address closes one) and counts each loop's instructions by opcode. The
row loop of ``csrc/myers_step.cuh``'s ``scan_rows`` is the innermost loop
with the most ``LOP3`` instructions; it is unrolled ``UNROLL`` times
(``#pragma unroll 4``), so its instructions per pattern row are its
count over ``UNROLL``. Instructions are split by where they issue:
memory (``LD*``, ``ST*``, ``ATOM*``, ``RED*``), control (branches,
barriers, ``NOP``), the uniform datapath (``U*``, once per warp), the
FMA pipe (``IMAD*``), and the rest, the integer ALU pipe (``LOP3``,
``SHF``, ``IADD3``, ``ISETP``, ``SEL``, ...): 16 lanes per SM sub-partition
per clock on the H100, half the issue rate, so it bounds the row loop.
Its count per row is ``chip_smoke.py``'s ``ROW_OPS``. Prints one JSON line
per kernel function.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

#: the row loop's unroll factor in scan_rows (#pragma unroll 4)
UNROLL = 4
EQ_NAMES = {0: "iupac", 1: "pure", 2: "ascii"}
CONTROL = ("BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BSSY",
           "BSYNC", "BAR", "WARPSYNC", "NOP", "YIELD", "BREAK")
MEMORY = ("LD", "ST", "ATOM", "RED")

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_INSN = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_KERNEL = re.compile(r"(scan(?:_q)?(?:_meta)?_kernel)ILi(\d)ELb([01])E")


def disassemble(lib: Path) -> str:
    """``cuobjdump -sass`` of the library, next to nvcc or on PATH."""
    from sassy_tpu_torch.ops import myers_cuda

    nvcc = myers_cuda.nvcc_path()
    tool = (Path(nvcc).with_name("cuobjdump") if nvcc else None)
    exe = str(tool) if tool and tool.exists() else shutil.which("cuobjdump")
    if exe is None:
        raise SystemExit("cuobjdump not found")
    return subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def functions(sass: str) -> dict:
    """{mangled name: [(address, opcode, operands)]}."""
    out: dict = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4).strip()))
    return out


def kind(opcode: str) -> str:
    base = opcode.split(".")[0]
    if base.startswith(MEMORY):
        return "memory"
    if base in CONTROL:
        return "control"
    if base.startswith("U"):
        return "uniform"
    if base.startswith("IMAD"):
        return "fma"
    return "alu"


def innermost_loops(insns) -> list:
    """[(start, end)] address ranges closed by a backward branch that hold
    no other such range."""
    loops = []
    for addr, op, args in insns:
        if op.split(".")[0] not in ("BRA", "JMP"):
            continue
        m = re.search(r"0x([0-9a-f]+)", args)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    return [lp for lp in loops
            if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                       for o in loops)]


def loop_stats(insns, lo: int, hi: int) -> dict:
    body = [op.split(".")[0] for a, op, _ in insns if lo <= a <= hi]
    kinds = Counter(kind(op) for op in body)
    return {"range": [hex(lo), hex(hi)], "insns": len(body),
            **{k: kinds[k] for k in ("alu", "fma", "uniform", "memory",
                                     "control")},
            "opcodes": dict(Counter(body))}


def report(sass: str) -> list[dict]:
    rows = []
    for name, insns in functions(sass).items():
        m = _KERNEL.search(name)
        if not m or not insns:
            continue
        loops = [loop_stats(insns, lo, hi) for lo, hi in innermost_loops(insns)]
        loops.sort(key=lambda s: s["opcodes"].get("LOP3", 0), reverse=True)
        row = {"kernel": m.group(1), "eq": EQ_NAMES[int(m.group(2))],
               "reg_rows": m.group(3) == "1", "insns": len(insns),
               "loops": len(loops)}
        if loops:
            main = loops[0]
            row["row_loop"] = main
            row["alu_per_row"] = main["alu"] / UNROLL
            row["insns_per_row"] = main["insns"] / UNROLL
        rows.append(row)
    rows.sort(key=lambda r: (r["kernel"], r["eq"], r["reg_rows"]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sass")
    ap.add_argument("--dump")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if a.sass:
        sass = Path(a.sass).read_text()
    else:
        from sassy_tpu_torch.ops import myers_cuda

        sass = disassemble(myers_cuda.build())
        if a.dump:
            Path(a.dump).parent.mkdir(parents=True, exist_ok=True)
            Path(a.dump).write_text(sass)
    lines = [json.dumps(r) for r in report(sass)]
    if not lines:
        raise SystemExit("no scan kernel found in the disassembly")
    print("\n".join(lines))
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
