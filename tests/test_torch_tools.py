"""The SASS counter of ``sassy_tpu_torch.tools.sass_count`` on small
hand-written disassemblies in ``cuobjdump -sass``'s layout."""

import pytest

from sassy_tpu_torch.tools import sass_count

_HEAD = """
	code for sm_90a
		Function : _ZN45_GLOBAL__N__13d5bd0a_12_scan_meta_cu_8c3acd9016{name}ILi{eq}ELb{reg}EEEv4Args
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
"""


def _fn(name, eq, reg, body):
    lines = [f"        /*{16 * i:04x}*/                   {insn} ;"
             "                 /* 0x000fe20000000800 */"
             for i, insn in enumerate(body)]
    return _HEAD.format(name=name, eq=eq, reg=reg) + "\n".join(lines) + "\n"


# an outer loop (0x10..0xb0) around an inner row loop (0x30..0x90)
_NESTED = [
    "LDC R1, c[0x0][0x28]",
    "LDG.E R2, desc[UR4][R8.64]",
    "LDS.128 R4, [R3]",
    "LOP3.LUT R5, R4, R2, R6, 0xf8, !PT",
    "IMAD.SHL.U32 R7, R5, 0x2, RZ",
    "UIADD3 UR4, UR4, 0x4, URZ",
    "LOP3.LUT R9, R7, R6, R5, 0x96, !PT",
    "SHF.R.U32.HI R10, RZ, 0x1f, R9",
    "ISETP.NE.AND P0, PT, R11, RZ, PT",
    "@P0 BRA 0x30",
    "STG.E desc[UR4][R12.64], R9",
    "@!P1 BRA 0x10",
    "EXIT",
]


def test_innermost_loop_and_kinds():
    (row,) = sass_count.report(_fn("scan_meta_kernel", 0, 1, _NESTED))
    assert (row["kernel"], row["eq"], row["reg_rows"]) == (
        "scan_meta_kernel", "iupac", True)
    loop = row["row_loop"]
    assert loop["range"] == ["0x30", "0x90"]
    assert [loop[k] for k in ("insns", "alu", "fma", "uniform", "memory",
                              "control")] == [7, 4, 1, 1, 0, 1]
    assert row["alu_per_row"] == 4 / sass_count.UNROLL
    assert row["insns_per_row"] == 7 / sass_count.UNROLL


@pytest.mark.parametrize("name,eq,label", [
    ("scan_q_kernel", 1, "pure"), ("scan_q_meta_kernel", 2, "ascii")])
def test_names_and_no_loop(name, eq, label):
    body = ["LDC R1, c[0x0][0x28]", "LOP3.LUT R5, R4, R2, R6, 0xf8, !PT",
            "EXIT"]
    sass = _fn(name, eq, 0, body) + _fn("other_kernel", 0, 1, _NESTED)
    (row,) = sass_count.report(sass)
    assert (row["kernel"], row["eq"], row["reg_rows"]) == (name, label, False)
    assert row["loops"] == 0 and "row_loop" not in row


def test_row_loop_is_the_loop_with_most_lop3():
    body = _NESTED[:10] + [
        "IADD3 R1, R1, 0x1, RZ", "ISETP.GE.AND P2, PT, R1, R2, PT",
        "@!P2 BRA 0xa0"] + _NESTED[10:]
    (row,) = sass_count.report(_fn("scan_kernel", 0, 1, body))
    assert row["loops"] == 2
    assert row["row_loop"]["range"] == ["0x30", "0x90"]
