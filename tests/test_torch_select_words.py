"""The word-level selection with the state chain inside, on the CPU.

``minima.select_words_chained`` (the entry point all three engines call)
runs ``select_words_chained_plain`` for CPU tensors: the chain
(``chain_range`` from the meta scans' ``final`` codes, reset at the tiles
of ``is_start``, after the carry in) and ``select_words_tiles_q_plain``.
Here: that plain version equals the JAX package's chain
(``tile_state_chain_codes`` with a seed code) and ``select_words_tiles_q``
on the same inputs, carry out included; and a g++ build of
``csrc/select_words.cuh`` (the kernels' grid, per-word work and chain,
through ``tests/torch_select_words_host.cc``, which runs the kernels'
three launches one block after another) equals the plain versions, in
the same order. The kernels themselves run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Exact equality: every
output is an integer.
"""

import ctypes
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sassy_tpu.ops import minima as ref_minima
from sassy_tpu_torch.ops import minima, myers_cuda
from test_torch_cuda import _chained_words as _chained_args
from test_torch_cuda import _word_carry as _carry
from test_torch_overhang_ops import _u


#: (Q, T, NW, k, starts, overhang, all_minima, carry)
CASES = [(3, 200, 6, 5, 0.2, False, False, None),
         (3, 200, 6, 5, 0.05, True, False, "carry"),
         (2, 300, 5, 6, 0.0, True, False, "seed"),
         (4, 120, 8, 4, 0.5, False, False, "seed"),
         (3, 200, 6, 5, 0.2, True, True, "carry")]


@pytest.mark.parametrize("case", CASES)
def test_chained_plain_equals_reference(case):
    """The chain of JAX's ``tile_state_chain_codes`` seeded by the carry
    (a code at a pseudo tile before tile 0), then its
    ``select_words_tiles_q``, against ``select_words_chained_plain``: the
    candidates, and the state after the last tile (the chain over one
    more, virtual tile) against the carry out. Text starts mid-range and
    an n_prev strip with text ends where the case has them."""
    Q, T, NW, k, starts, overhang, all_minima, kind = case
    args = _chained_args(Q, T, NW, k, Q + T, starts, overhang)
    args[6] = _carry(kind, Q)
    args[12] = all_minima
    (vp, vm, cost, meta, final, is_start, carry, vf, vt, islast, pos_base, _,
     _, tend, alpha, n_prev) = args
    got, got_carry = minima.select_words_chained(*args)

    seed = (np.zeros(Q, np.int32) if carry is None
            else carry.numpy()[:, 0].astype(np.int32))
    tl = np.concatenate([final.numpy(), np.zeros((Q, 1), np.int32)], 1)
    st = np.asarray(ref_minima.tile_state_chain_codes(
        jax, jnp, jnp.asarray(tl), jnp.asarray(np.append(is_start.numpy(),
                                                         False)),
        seed_code=jnp.asarray(seed)))
    state0 = np.zeros((Q, T), np.int32) if all_minima else st[:, :T]
    want_carry = (seed if all_minima else np.where(st[:, T] == 1, 3, 0))
    cap, wcap = Q * NW * T * 33, Q * NW * T
    extra = ({} if not overhang else {
        "text_end": jnp.asarray(tend.numpy().astype(np.int32)),
        "alpha": jnp.float32(alpha), "n_prev": n_prev})
    packed = np.asarray(ref_minima.select_words_tiles_q(
        jax, jnp, _u(vp), _u(vm), jnp.asarray(cost.numpy()),
        jnp.asarray(meta.numpy()), jnp.asarray(vf.numpy()),
        jnp.asarray(vt.numpy()), jnp.asarray(islast.numpy()),
        jnp.asarray(pos_base.numpy().astype(np.int32)), k,
        jnp.asarray(state0), all_minima, cap, wcap, **extra))
    total = int(packed[0])
    pos = packed[3 : 3 + total]
    qc = packed[3 + cap : 3 + cap + total]
    cost16 = ((qc & 0xFFFF) ^ 0x8000) - 0x8000
    want = sorted(zip((qc >> 16).tolist(), pos.tolist(), cost16.tolist()))
    q, tile, gpos, gcost = got.tolist()
    assert want and sorted(zip(q, gpos, gcost)) == want
    np.testing.assert_array_equal(got_carry.numpy()[:, 0], want_carry)


def test_chained_cpu_tensors_run_the_plain_version():
    """On CPU tensors the entry point calls its plain version once (which
    runs the chain, then the tile-state selection) and moves no kernel
    counter; its result is the tile-state selection's with the chain's
    states."""
    args = _chained_args(3, 150, 6, 5, 1, overhang=True)
    args[6] = _carry("carry", 3)
    launches = (myers_cuda.select_words.launches,
                myers_cuda.select_words_chained.launches)
    calls = (minima.select_words_chained_plain.calls,
             minima.select_words_tiles_q_plain.calls)
    got, carry = minima.select_words_chained(*args)
    assert (minima.select_words_chained_plain.calls,
            minima.select_words_tiles_q_plain.calls) == (calls[0] + 1,
                                                         calls[1] + 1)
    assert (myers_cuda.select_words.launches,
            myers_cuda.select_words_chained.launches) == launches
    state0, want_carry = minima.chain_range(args[4], args[5], args[6])
    want = minima.select_words_tiles_q_plain(
        *args[:4], *args[7:11], args[11], state0, *args[12:])
    assert got.shape[1] and torch.equal(got, want)
    assert torch.equal(carry, want_carry)


def test_chained_other_devices_raise():
    """Tensors on neither the CPU nor a CUDA device go to the kernel
    wrapper, which refuses them before any build or launch."""
    args = _chained_args(2, 40, 4, 5, 2)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="cpu or cuda"):
        minima.select_words_chained(*meta)


# ---------------------------------------------------------------------------
# the kernels' grid, per-word work and chain (csrc/select_words.cuh) on the
# host, through a g++ build


def _words_host():
    """The host program over select_words.cuh, built with g++ (no fused
    float products, as the card rounds them) into build/sassy_tpu_torch/."""
    from sassy_tpu_torch import gxx

    here = os.path.dirname(os.path.abspath(__file__))
    csrc = myers_cuda.CSRC
    lib = ctypes.CDLL(str(gxx.build(
        "select_words_host",
        [os.path.join(here, "torch_select_words_host.cc"),
         csrc / "select_words.cuh", csrc / "select_common.cuh"],
        ["-std=c++17", "-O1", "-shared", "-fPIC", "-ffp-contract=off",
         f"-I{csrc}"])))
    ptr, num, big = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sassy_words_scratch.argtypes = [num] * 3
    lib.sassy_words_scratch.restype = big
    lib.sassy_words_host.argtypes = ([ptr] * 16 + [big] + [num] * 6
                                     + [ctypes.c_float, num])
    return lib


def _host_select(lib, vp, vm, cost, meta, final, is_start, carry, vf, vt,
                 islast, pos_base, k, all_minima, tend=None, alpha=None,
                 n_prev=0, state0=None):
    """The host passes on numpy copies, as the wrapper drives the
    kernels: count, scan, read the total, write. Returns the (4, N)
    columns and the (Q, 1) carry out."""
    Q, NW, T = vp.shape
    arr = lambda x, dt: None if x is None else np.ascontiguousarray(  # noqa: E731
        x.numpy()).astype(dt)
    keep = [arr(vp, np.int32), arr(vm, np.int32), arr(cost, np.int32),
            arr(meta, np.int32), arr(vf, np.int32), arr(vt, np.int32),
            arr(islast, np.int32), arr(pos_base, np.int64),
            arr(tend, np.int64), arr(final, np.int32),
            arr(is_start, np.uint8), arr(state0, np.int32),
            arr(carry, np.int32)]
    ptrs = [None if x is None else x.ctypes.data for x in keep]
    carry_out = np.full((Q, 1), -7, np.int32)
    scratch = np.zeros(lib.sassy_words_scratch(Q, NW, T), np.int64)

    def run(pass_, out=None, N=0):
        lib.sassy_words_host(
            *ptrs, carry_out.ctypes.data, scratch.ctypes.data,
            None if out is None else out.ctypes.data, N, Q, NW, T, k,
            int(all_minima), n_prev, 0.0 if alpha is None else alpha, pass_)

    run(0)
    run(1)
    N = int(scratch[-1])
    out = np.zeros((4, N), np.int64)
    if N:
        run(2, out, N)
    return torch.from_numpy(out), torch.from_numpy(carry_out)


#: (Q, T, NW, k, starts, overhang, all_minima, carry, quiet): rows cut
#: into several tile chunks (T > 4096) and chunks holding several rows
#: (T < 4096), one tile, tiles without a delta, resets mid-range
HOST_CASES = [(3, 200, 6, 5, 0.2, False, False, None, 0.2),
              (2, 9000, 2, 5, 0.002, False, False, "carry", 0.5),
              (2, 9000, 2, 5, 0.002, True, False, "seed", 0.9),
              (3, 5000, 3, 4, 0.0, True, True, "carry", 0.3),
              (5, 1, 9, 6, 0.5, True, False, "carry", 0.0),
              (2, 700, 9, 5, 0.01, True, False, "seed", 0.95),
              (3, 200, 6, -40, 0.2, False, False, "carry", 0.2)]


@pytest.mark.parametrize("case", HOST_CASES)
def test_words_host_equals_plain(case):
    """The kernels' decomposition on the host (every block's counts for
    both entering states of its segment, the segments composed in order
    from each pattern's carry, the blocks' offsets, the candidates written
    at them) against ``select_words_chained_plain``: the same columns in
    the same order, the same carry out."""
    Q, T, NW, k, starts, overhang, all_minima, kind, quiet = case
    args = _chained_args(Q, T, NW, k, Q * T + NW, starts, overhang, quiet)
    args[6] = _carry(kind, Q)
    args[12] = all_minima
    want, want_carry = minima.select_words_chained_plain(*args)
    got, carry = _host_select(_words_host(), *args)
    assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(carry, want_carry.to(torch.int32))
    assert want.shape[1] or k < 0


@pytest.mark.parametrize("T,overhang", [(300, True), (6000, False)])
def test_words_host_with_tile_states_equals_plain(T, overhang):
    """Without the chain's inputs every tile enters with its state0: the
    host decomposition against ``select_words_tiles_q_plain``."""
    Q, NW, k = 3, 3, 5
    args = _chained_args(Q, T, NW, k, T, overhang=overhang)
    state0 = torch.from_numpy(
        np.random.default_rng(T).integers(0, 2, (Q, T)).astype(np.int32))
    want = minima.select_words_tiles_q_plain(
        *args[:4], *args[7:11], k, state0, False, *args[13:])
    got, _ = _host_select(_words_host(), *args[:4], None, None, None,
                          *args[7:13], *args[13:], state0=state0)
    assert want.shape[1] and torch.equal(got, want)
