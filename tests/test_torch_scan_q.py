"""The plain version of the q2meta kernel and the pattern-batched
selection against the JAX package: the Pallas kernel in interpret mode,
its XLA path, the cross-tile state chain over (Q, T) and
``select_words_tiles_q``. Exact equality: all outputs are integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sassy_tpu.ops import minima as ref_minima
from sassy_tpu.ops.myers_pallas import get_pallas_scan_q2_meta
from sassy_tpu.ops.myers_xla import _kernels
from sassy_tpu_torch.ops import minima, myers_cuda
from sassy_tpu_torch.ops.myers_torch import Windows
from test_torch_cuda import _described, _random_q_inputs

OUT = ("vp", "vm", "cost", "meta", "final")


def _np(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _assert_outputs_equal(got, want):
    for name, g, w in zip(OUT, got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w), err_msg=name)


@pytest.mark.parametrize("eq_mode,Q,M,NW", [
    ("iupac", 3, 8, 4),
    ("pure", 2, 8, 4),
    ("ascii", 3, 8, 2),
    ("iupac", 2, 72, 2),  # past the kernel's register rows
])
def test_q_plain_equals_pallas_interpret(eq_mode, Q, M, NW):
    """The Pallas q2meta kernel itself, in interpret mode at one (8, 128)
    lane group (T = 1024 tiles). It takes an even Q (an odd one is padded
    with a copy of the last pattern, as the JAX package pads it) and
    ascii masks as wide as the windows' 9 planes."""
    args = _random_q_inputs(eq_mode, Q, M, T=1024, NW=NW, seed=Q + M)
    win, tile0, vf, vt, pm, ip, hi, m_real, bm, k, _ = args
    P = win.shape[1]
    pm = pm.numpy()
    if eq_mode == "ascii":
        pm = np.concatenate([pm, np.zeros((Q, M, 1), np.int32)], axis=2)

    def even(a):
        a = np.asarray(a)
        return jnp.asarray(np.concatenate([a, a[-1:]]) if Q % 2 else a)

    lanes = lambda a: jnp.asarray(  # noqa: E731
        a.numpy().astype(np.int32).reshape(1, 8, 128))
    call = get_pallas_scan_q2_meta("ascii" if eq_mode == "ascii" else "iupac",
                                   P, M, NW, True, pure=eq_mode == "pure")
    outs = call(
        jnp.asarray(win.numpy()).reshape(NW, P, 1, 8, 128)
        .transpose(2, 0, 1, 3, 4),
        lanes(tile0), lanes(vf), lanes(vt), even(pm), even(ip.numpy()),
        even(hi.numpy()), even(np.stack([m_real.numpy(), bm.numpy()], 1)),
        jnp.asarray(k),
    )
    want = [np.asarray(o)[:Q].transpose(0, 2, 1, 3, 4).reshape(Q, NW, 1024)
            for o in outs[:4]]
    want.append(np.asarray(outs[4])[:Q].reshape(Q, 1024))
    _assert_outputs_equal(myers_cuda.scan_q_meta_plain(*_described(args)),
                          want)


@pytest.mark.parametrize("eq_mode", ["iupac", "pure", "ascii"])
@pytest.mark.parametrize("Q,M", [(2, 24), (3, 24), (3, 72)])
def test_q_plain_equals_xla_path(eq_mode, Q, M):
    """``_scan_win_q_meta`` on the XLA backend (the Pallas kernel's bits by
    construction), odd and even Q, mixed m_real in one row bucket."""
    args = _random_q_inputs(eq_mode, Q, M, T=96, NW=7, seed=10 * Q + M + 1)
    assert len(set(args[7].tolist())) > 1
    win, tile0, vf, vt, pm, ip, hi, m_real, bm, k, _ = args
    u = lambda a: jnp.asarray(a.numpy().view(np.uint32))  # noqa: E731
    want = _kernels()["scan_win_q_meta"](
        u(win), jnp.asarray(tile0.numpy()), jnp.asarray(vf.numpy()),
        jnp.asarray(vt.numpy()), u(pm), u(ip), u(hi),
        jnp.asarray(m_real.numpy()), jnp.asarray(bm.numpy()), k,
        "ascii" if eq_mode == "ascii" else "iupac", "xla", False,
    )
    got = myers_cuda.scan_q_meta(*_described(args))  # CPU: the plain version
    _assert_outputs_equal(got, want)


def test_cpu_tensors_take_the_q_plain_version():
    before = myers_cuda.scan_q_meta.launches
    args = _described(_random_q_inputs("pure", 2, 16, T=32, NW=3, seed=2))
    _assert_outputs_equal(myers_cuda.scan_q_meta(*args),
                          myers_cuda.scan_q_meta_plain(*args))
    assert myers_cuda.scan_q_meta.launches == before


def test_q_kernel_takes_no_other_device():
    win = Windows.of(torch.empty((3, 4, 8), dtype=torch.int32,
                                 device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        myers_cuda.scan_q_meta(win, *([torch.empty(0)] * 8), 1, "iupac")


def test_tile_state_chain_codes_over_patterns():
    """One chain per pattern row: (Q, T) codes, starts shared."""
    rng = np.random.default_rng(4)
    Q, T = 5, 3000
    tl = rng.choice(np.array([0, 2, 3], np.int32), (Q, T), p=[0.6, 0.2, 0.2])
    is_start = rng.random(T) < 0.02
    want = ref_minima.tile_state_chain_codes(jax, jnp, jnp.asarray(tl),
                                             jnp.asarray(is_start))
    got = minima.tile_state_chain_codes(torch.from_numpy(tl),
                                        torch.from_numpy(is_start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for q in range(Q):  # row q is the single chain of pattern q
        one = minima.tile_state_chain_codes(torch.from_numpy(tl[q]),
                                            torch.from_numpy(is_start))
        np.testing.assert_array_equal(one.numpy(), got[q].numpy())


@pytest.mark.parametrize("all_minima", [False, True])
@pytest.mark.parametrize("eq_mode,M", [("iupac", 24), ("pure", 40)])
def test_select_words_tiles_q_equals_reference(eq_mode, M, all_minima):
    """Scan outputs of random windows, random cross-tile seeds; the JAX
    selection's packed output decoded to (pattern, position, cost)."""
    Q, T, NW = 3, 200, 6
    args = _random_q_inputs(eq_mode, Q, M, T=T, NW=NW, seed=M)
    k = 4
    args = (*args[:9], k, eq_mode)
    vp, vm, cost, meta, _ = myers_cuda.scan_q_meta_plain(*_described(args))
    vf, vt = args[2], args[3]
    rng = np.random.default_rng(M)
    islast = np.where(rng.random(T) < 0.3, vt.numpy(), -1).astype(np.int32)
    state0 = rng.integers(0, 2, (Q, T)).astype(np.int32)
    stride = NW * 32 + 1
    pos_base = np.arange(T, dtype=np.int64) * stride

    cap, wcap = 1 << 15, 2048  # the word cap must not pass the grid
    u = lambda a: jnp.asarray(a.numpy().view(np.uint32))  # noqa: E731
    packed = np.asarray(ref_minima.select_words_tiles_q(
        jax, jnp, u(vp), u(vm), jnp.asarray(cost.numpy()),
        jnp.asarray(meta.numpy()), jnp.asarray(vf.numpy()),
        jnp.asarray(vt.numpy()), jnp.asarray(islast),
        jnp.asarray(pos_base.astype(np.int32)), k, jnp.asarray(state0),
        all_minima, cap, wcap,
    ))
    total = int(packed[0])
    assert 0 < total < cap and packed[1] <= wcap
    pos = packed[3 : 3 + total]
    qc = packed[3 + cap : 3 + cap + total]
    # qid << 16 | cost in 16 bits; random states reach negative costs
    cost16 = ((qc & 0xFFFF) ^ 0x8000) - 0x8000
    want = sorted(zip((qc >> 16).tolist(), pos.tolist(), cost16.tolist()))

    q, tile, gpos, gcost = minima.select_words_tiles_q(
        vp, vm, cost, meta, vf, vt, torch.from_numpy(islast),
        torch.from_numpy(pos_base), k, torch.from_numpy(state0), all_minima,
    ).tolist()
    assert all(p // stride == t for p, t in zip(gpos, tile))
    assert sorted(zip(q, gpos, gcost)) == want
