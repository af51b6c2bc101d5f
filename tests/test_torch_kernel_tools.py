"""The plain versions of the kernel-design family (``scan_qn``) and of the
row-step ablations (``scan_variant``) against the JAX package: the Pallas
kernels of ``scripts/kernel_qn.py`` and ``get_pallas_scan_q`` in interpret
mode at one (8, 128) lane group, ``get_pallas_scan`` for the ``full``
ablation, and a numpy transcription of ``scripts/kernel_variants.py`` for
the other three. Exact equality: all outputs are integers. Then the
wrappers' argument checks and the two tools' CPU runs.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sassy_tpu.ops.myers_pallas import get_pallas_scan, get_pallas_scan_q
from sassy_tpu_torch.ops import myers_cuda
from sassy_tpu_torch.ops.myers_torch import Windows
from sassy_tpu_torch.tools import kernel_qn, kernel_variants, timing
from test_torch_cuda import _random_q_inputs

REPO = Path(__file__).resolve().parent.parent
T, NW, M, Q = 1024, 4, 8, 8
OUT = ("vp", "vm", "cost")


def _script():
    """``scripts/kernel_qn.py`` as a module (its mains run only as
    ``__main__``)."""
    spec = importlib.util.spec_from_file_location(
        "ref_kernel_qn", REPO / "scripts" / "kernel_qn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _qn_args(eq_mode, seed):
    """(windows, tile0, pmasks, is_pad, h_init, m_real, boundary_m,
    eq_mode) of Q patterns with mixed pad rows over one lane group."""
    a = _random_q_inputs(eq_mode, Q, M, T=T, NW=NW, seed=seed)
    return (a[0], a[1], *a[4:9], eq_mode)


def _pallas_outputs(call, args, n_mask_planes):
    """Run a (Q, G)-grid Pallas call on the port's inputs: windows
    (NW, P, T) -> (1, NW, P, 8, 128), outputs (Q, 1, NW, 8, 128) ->
    (Q, NW, T)."""
    win, tile0, pm, ip, hi, m_real, bm, _ = args
    P = win.shape[1]
    pm = pm.numpy()
    if pm.shape[2] < n_mask_planes:  # ascii: masks as wide as the planes
        pm = np.concatenate(
            [pm, np.zeros((*pm.shape[:2], n_mask_planes - pm.shape[2]),
                          np.int32)], axis=2)
    outs = call(
        jnp.asarray(win.numpy()).reshape(NW, P, 1, 8, 128)
        .transpose(2, 0, 1, 3, 4),
        jnp.asarray(tile0.numpy().astype(np.int32).reshape(1, 8, 128)),
        jnp.asarray(pm), jnp.asarray(ip.numpy()), jnp.asarray(hi.numpy()),
        jnp.asarray(np.stack([m_real.numpy(), bm.numpy()], 1)),
    )
    return [np.asarray(o).reshape(Q, NW, T) for o in outs]


def _assert_equal(got, want):
    for name, g, w in zip(OUT, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("eq_mode", ["iupac", "ascii"])
def test_qn_plain_equals_pallas_scan_q(eq_mode):
    """U = 1, loop, WU = 1 is ``get_pallas_scan_q``."""
    args = _qn_args(eq_mode, seed=3)
    P = args[0].shape[1]
    want = _pallas_outputs(get_pallas_scan_q(eq_mode, P, M, NW, True), args, P)
    _assert_equal(myers_cuda.scan_qn_plain(*args), want)
    _assert_equal(myers_cuda.scan_qn(*args), want)  # CPU: the plain version


@pytest.mark.parametrize("U", [1, 2, 4, 8])
def test_qn_plain_equals_make_call(U):
    args = _qn_args("iupac", seed=10 + U)
    call = _script().make_call(U, "iupac", 4, M, NW, interpret=True)
    _assert_equal(myers_cuda.scan_qn_plain(*args, U=U),
                  _pallas_outputs(call, args, 4))


@pytest.mark.parametrize("U", [2, 1])
def test_qn_plain_equals_make_call_unroll(U):
    args = _qn_args("iupac", seed=20 + U)
    call = _script().make_call_unroll(U, "iupac", 4, M, NW, interpret=True)
    _assert_equal(myers_cuda.scan_qn_plain(*args, U=U, unroll=True),
                  _pallas_outputs(call, args, 4))


@pytest.mark.parametrize("U,WU", [(2, 2), (2, 4), (1, 2)])
def test_qn_plain_equals_make_call_unroll_w(U, WU):
    args = _qn_args("iupac", seed=30 + 4 * U + WU)
    call = _script().make_call_unroll_w(U, "iupac", 4, M, NW, WU,
                                        interpret=True)
    _assert_equal(myers_cuda.scan_qn_plain(*args, U=U, unroll=True, WU=WU),
                  _pallas_outputs(call, args, 4))


def test_qn_rejects_shapes_that_do_not_split():
    args = _qn_args("iupac", seed=1)
    small = (args[0][:3, :, :8].contiguous(), args[1][:8], *args[2:])
    with pytest.raises(ValueError, match="groups of U = 3"):
        myers_cuda.scan_qn(*small, U=3)
    with pytest.raises(ValueError, match="WU = 2"):
        myers_cuda.scan_qn(*small, WU=2)
    long_ = _random_q_inputs("iupac", 2, 72, T=8, NW=2, seed=5)
    with pytest.raises(ValueError, match="M = 72 > 64"):
        myers_cuda.scan_qn(long_[0], long_[1], *long_[4:9], "iupac")


@pytest.mark.parametrize("eq_mode,M_,U,unroll,WU,built", [
    ("iupac", 24, 8, False, 1, True), ("ascii", 24, 1, False, 1, True),
    ("pure", 40, 1, False, 1, True), ("ascii", 24, 2, False, 1, False),
    ("iupac", 24, 2, True, 4, True), ("iupac", 64, 1, True, 2, True),
    ("iupac", 32, 2, True, 1, False), ("iupac", 24, 4, True, 1, False),
    ("iupac", 24, 2, False, 2, False),
])
def test_qn_members_built(eq_mode, M_, U, unroll, WU, built):
    """The members the wrapper takes on a CUDA device are the ones
    ``csrc/scan_qn.cu`` lists."""
    assert myers_cuda.qn_member_built(eq_mode, M_, U, unroll, WU) is built
    eq = {"iupac": "kEqIupac", "pure": "kEqPure", "ascii": "kEqAscii"}[eq_mode]
    listed = f"X({eq}, {U}, {M_ if unroll else 0}, {WU})" in (
        myers_cuda.CSRC / "scan_qn.cu").read_text()
    assert listed is built


def _variant_inputs(seed, tiles=96, words=5, rows=24):
    rng = np.random.default_rng(seed)
    win = rng.integers(0, 2**32, (words, 4, tiles), dtype=np.uint64)
    pm = rng.integers(0, 2**32, (rows, 4), dtype=np.uint64)
    return win.astype(np.uint32), pm.astype(np.uint32)


def _variant_numpy(win, pm, variant):
    """``scripts/kernel_variants.py``'s kernel in numpy on uint32 (its
    ``make`` is nested in a ``main`` that builds a TPU call and cannot be
    loaded without running it). Windows (NW, P, T); returns vp (NW, T),
    and for ``nostore`` the popcount sums, which the script writes to its
    output's first word."""
    n_words, P, tiles = win.shape
    rows = pm.shape[0]
    one = np.uint32(1)
    hp = np.ones((rows, tiles), np.uint32)
    hm = np.zeros((rows, tiles), np.uint32)
    acc = np.zeros(tiles, np.int64)
    out = np.zeros((1 if variant == "nostore" else n_words, tiles), np.uint32)
    for w in range(n_words):
        vp = np.zeros(tiles, np.uint32)
        vm = np.zeros(tiles, np.uint32)
        for j in range(rows):
            if variant == "noeq":
                eq = win[w, 0]
            else:
                eq = np.zeros(tiles, np.uint32)
                for p in range(P):
                    eq = eq | (win[w, p] & pm[j, p])
            if variant == "nomem":
                hp_j, hm_j = vp, vm
            else:
                hp_j, hm_j = hp[j].copy(), hm[j].copy()
            vx = eq | vm
            eqh = eq | hm_j
            hx = (((eqh & vp) + vp) ^ vp) | eqh
            hp_o = vm | ~(hx | vp)
            hm_o = vp & hx
            if variant != "nomem":
                hp[j] = hp_o >> np.uint32(31)
                hm[j] = hm_o >> np.uint32(31)
            hp_sh = (hp_o << one) | hp_j
            hm_sh = (hm_o << one) | hm_j
            vp, vm = hm_sh | ~(vx | hp_sh), hp_sh & vx
        if variant != "nostore":
            out[w] = vp
        acc += np.bitwise_count(vp)
    if variant == "nostore":
        out[0] = acc.astype(np.uint32)
    return out.view(np.int32)


def _t(a):
    return torch.from_numpy(a.view(np.int32).copy())


@pytest.mark.parametrize("variant", ["noeq", "nomem", "nostore", "full"])
def test_variant_plain_equals_script_arithmetic(variant):
    win, pm = _variant_inputs(seed=len(variant))
    want = _variant_numpy(win, pm, variant)
    np.testing.assert_array_equal(
        myers_cuda.scan_variant_plain(_t(win), _t(pm), variant).numpy(), want)
    np.testing.assert_array_equal(  # CPU tensors: the plain version
        myers_cuda.scan_variant(_t(win), _t(pm), variant).numpy(), want)


def test_variant_full_equals_pallas_scan():
    """``full`` is the q1 kernel's vp for a pattern without pad rows, every
    tile from the plain boundary (h deltas 1, no text-start tile)."""
    win, pm = _variant_inputs(seed=7, tiles=1024, words=3, rows=8)
    call = get_pallas_scan("iupac", 4, 8, 3, True)
    vp = call(
        jnp.asarray(win.view(np.int32)).reshape(3, 4, 1, 8, 128)
        .transpose(2, 0, 1, 3, 4),
        jnp.zeros((1, 8, 128), jnp.int32), jnp.asarray(pm.view(np.int32)),
        jnp.zeros(8, jnp.int32), jnp.ones(8, jnp.int32), jnp.int32(8),
        jnp.int32(8),
    )[0]
    np.testing.assert_array_equal(
        myers_cuda.scan_variant_plain(_t(win), _t(pm), "full").numpy(),
        np.asarray(vp).transpose(1, 0, 2, 3).reshape(3, 1024))


def test_variant_rejects_bad_inputs():
    win, pm = _variant_inputs(seed=2, tiles=8, words=2, rows=72)
    with pytest.raises(ValueError, match="M = 72 > 64"):
        myers_cuda.scan_variant(_t(win), _t(pm), "full")
    with pytest.raises(ValueError, match="unknown variant"):
        myers_cuda.scan_variant(_t(win), _t(pm[:8]), "nothing")
    nine = np.zeros((2, 9, 8), np.uint32)
    with pytest.raises(ValueError, match="4 planes"):
        myers_cuda.scan_variant(_t(nine), _t(pm[:8]), "full")
    meta = torch.empty((2, 4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        myers_cuda.scan_variant(meta, _t(pm[:8]), "full")


def test_cpu_tensors_launch_no_kernel():
    before = myers_cuda.scan_qn.launches, myers_cuda.scan_variant.launches
    args = _qn_args("iupac", seed=1)
    myers_cuda.scan_qn(args[0][:2, :, :4].contiguous(), args[1][:4], *args[2:],
                       U=2)
    win, pm = _variant_inputs(seed=1, tiles=4, words=2, rows=8)
    myers_cuda.scan_variant(_t(win), _t(pm), "nomem")
    assert (myers_cuda.scan_qn.launches,
            myers_cuda.scan_variant.launches) == before


@pytest.mark.parametrize("argv", [
    ["--shape", "script", "--tiles", "48", "--words", "4"],
    ["--shape", "script", "--tiles", "48", "--words", "4", "--unroll",
     "--wunroll"],
    ["--shape", "nanopore", "--tiles", "2", "--words", "4"],
    ["--shape", "long", "--tiles", "2", "--words", "4", "--wunroll"],
])
def test_kernel_qn_tool_runs_on_the_cpu(argv, capsys, tmp_path):
    out = tmp_path / "qn.txt"
    assert kernel_qn.main(["--device", "cpu", "--out", str(out), *argv]) == 0
    lines = capsys.readouterr().out.splitlines()
    timed = [ln for ln in lines if "cpu_ms" in ln]
    assert len(timed) >= 5 and all(ln.endswith(" ok") for ln in timed)
    assert not any("MISMATCH" in ln for ln in lines)
    assert out.read_text().splitlines() == lines


@pytest.mark.parametrize("argv", [
    ["--shape", "script", "--tiles", "48", "--words", "4"],
    ["--shape", "single", "--mib", "1", "--tiles", "32", "--words", "6"],
])
def test_kernel_variants_tool_runs_on_the_cpu(argv, capsys):
    assert kernel_variants.main(["--device", "cpu", *argv]) == 0
    lines = capsys.readouterr().out.splitlines()
    names = [ln.split()[0] for ln in lines if "cpu_ms" in ln]
    assert names == ["scan", "full", "noeq", "nomem", "nostore"]
    assert all(ln.endswith(" ok") for ln in lines if "cpu_ms" in ln)


def test_tool_reports_a_mismatch(monkeypatch):
    """A member that differs from the plain version fails the tool."""
    plain = myers_cuda.scan_q_plain

    def off_by_one(*args):
        vp, vm, cost = plain(Windows.of(args[0]), *args[1:])
        return vp, vm, cost + 1

    monkeypatch.setattr(myers_cuda, "scan_qn_plain",
                        lambda *a, **kw: off_by_one(*a[:8]))
    lines = []
    with pytest.raises(SystemExit, match="differs"):
        kernel_qn.run("script", ("main",), "cpu", tiles=16, words=2,
                      log=lines.append)
    assert any(ln.endswith("MISMATCH") for ln in lines)


def test_kernel_resources_reads_the_compiler_report():
    log = """
ptxas info    : Compiling entry function '_ZN3fooscan_qn_kernelILi0ELi2ELi24ELi1EEEvNS_5QArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN3fooscan_qn_kernelILi0ELi2ELi24ELi1EEEvNS_5QArgsE
    40 bytes stack frame, 32 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 40 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN3fooscan_kernelILi0ELb1EEEvNS_4ArgsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
"""
    res = timing.kernel_resources(log)
    assert timing.registers(res, "scan_qn_kernel", 0, 2, 24, 1) == (
        "255+48B spill")
    assert timing.registers(res, "scan_kernel", 0, True) == "40"
    assert timing.registers(res, "scan_qn_kernel", 0, 4, 0, 1) == "?"
