"""The port's window build and the plain version of the q1meta kernel
against the JAX package: its window builder, the Pallas kernel in
interpret mode, and its XLA twin. Exact equality: all outputs are
integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sassy_tpu.ops import minima as ref_minima
from sassy_tpu.ops.myers_pallas import get_pallas_scan_meta
from sassy_tpu.ops.myers_xla import _kernels
from sassy_tpu_torch.ops.myers_cuda import scan_meta, scan_meta_plain
from sassy_tpu_torch.ops.myers_torch import build_windows
from test_torch_cuda import _random_inputs

OUT = ("vp", "vm", "cost", "meta", "final")


def _jax_args(args):
    """The torch inputs as the JAX functions take them (uint32 bits)."""
    win, tile0, vf, vt, pm, ip, hi = (a.numpy() for a in args[:7])
    u = lambda a: jnp.asarray(a.view(np.uint32))  # noqa: E731
    return (u(win), jnp.asarray(tile0), jnp.asarray(vf), jnp.asarray(vt),
            u(pm), u(ip), u(hi), *args[7:])


def _assert_outputs_equal(got, want):
    for name, g, w in zip(OUT, got, want):
        w = np.asarray(w)
        w = w.view(np.int32) if w.dtype == np.uint32 else w
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize(
    "gw,T,W,halo",
    [
        (80, 4, 16, 1),
        (80, 5, 10, 12),  # halo > W: two halo strips
        (100, 3, 40, 2),  # T*W > gw: padded tail
        (100, 1, 200, 0),  # one tile longer than the planes
        (300, 7, 33, 5),
    ],
)
def test_windows_equal_reference(gw, T, W, halo):
    rng = np.random.default_rng(gw + T + W + halo)
    planes = rng.integers(0, 2**32, (4, gw), dtype=np.uint64).astype(np.uint32)
    dummy = jnp.zeros((1,), jnp.uint32)
    want = _kernels()["scan_words"](
        jnp.asarray(planes), jnp.zeros((1, 4), jnp.uint32), dummy, dummy, 1,
        1, "iupac", T, W, halo, "return_windows", False,
    )
    got = build_windows(torch.from_numpy(planes.view(np.int32)), T, W, halo)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("eq_mode", ["iupac", "pure", "ascii"])
def test_plain_equals_pallas_interpret(eq_mode):
    """The Pallas kernel itself, run in interpret mode at one (8, 128) lane
    group: T = 1024 tiles, NW = 4 words, M = 8 rows."""
    args = _random_inputs(eq_mode, M=8, T=1024, NW=4, seed=11)
    win, tile0, vf, vt, pm, ip, hi, m_real, bm, k, _ = _jax_args(args)
    NW, P, T = win.shape
    i32 = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)  # noqa: E731
    lanes = lambda a: a.astype(jnp.int32).reshape(1, 8, 128)  # noqa: E731
    call = get_pallas_scan_meta("ascii" if eq_mode == "ascii" else "iupac",
                                P, 8, NW, True, pure=eq_mode == "pure")
    outs = call(
        i32(win).reshape(NW, P, 1, 8, 128).transpose(2, 0, 1, 3, 4),
        lanes(tile0), lanes(vf), lanes(vt), i32(pm), i32(ip), i32(hi),
        jnp.int32(m_real), jnp.int32(bm), jnp.asarray(k),
    )
    want = [o.transpose(1, 0, 2, 3).reshape(NW, T) for o in outs[:4]]
    want.append(outs[4].reshape(T))
    _assert_outputs_equal(scan_meta_plain(*args), want)


@pytest.mark.parametrize("eq_mode,M", [("iupac", 24), ("pure", 24),
                                       ("ascii", 24), ("iupac", 128),
                                       ("pure", 72)])
def test_plain_equals_xla_twin(eq_mode, M):
    """The XLA twin (the Pallas kernel's bits by construction) at the
    main path's M = 24 and past the kernel's register rows."""
    args = _random_inputs(eq_mode, M=M, T=96, NW=9, seed=M)
    jargs = list(_jax_args(args))
    jargs[-1] = "ascii" if eq_mode == "ascii" else "iupac"  # pure = iupac bits
    want = _kernels()["scan_win_meta"](*jargs, backend="xla", interpret=False)
    _assert_outputs_equal(scan_meta(*args), want)


def test_plain_equals_scan_core_and_meta_from_words():
    args = _random_inputs("iupac", M=40, T=64, NW=6, seed=5)
    win, tile0, vf, vt, pm, ip, hi, m_real, bm, k, _ = _jax_args(args)
    M, T = pm.shape[0], win.shape[2]
    hp0 = jnp.where(ip[:, None] != 0, jnp.uint32(0),
                    jnp.where(tile0[None, :], hi[:, None], jnp.uint32(1)))
    hm0 = jnp.zeros((M, T), jnp.uint32)
    cost0 = jnp.where(tile0, bm, m_real).astype(jnp.int32)
    vp, vm, cost = _kernels()["scan_core"](win, pm, ip, hp0, hm0, cost0,
                                           "iupac")
    meta, final = ref_minima.meta_from_words(jax, jnp, vp, vm, cost, vf, vt,
                                             k)
    _assert_outputs_equal(scan_meta_plain(*args), (vp, vm, cost, meta, final))


def test_cpu_tensors_take_the_plain_version():
    from sassy_tpu_torch.ops import myers_cuda

    before = myers_cuda.scan_meta.launches
    args = _random_inputs("pure", M=16, T=32, NW=3, seed=2)
    _assert_outputs_equal(scan_meta(*args), scan_meta_plain(*args))
    assert myers_cuda.scan_meta.launches == before
