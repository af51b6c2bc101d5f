"""The overhang path's pieces in the port against the JAX package: the 'N'
overlay and the window cache, the plain versions of the q1 and q2 kernels
(against the Pallas kernels in interpret mode and their XLA twins), the
position-level selections (single and batched), the cross-tile state
chain from raw deltas, the word-level selections with an overshoot strip,
and the float32 overshoot cost. Exact equality: all outputs are integers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sassy_tpu import profiles as ref_profiles
from sassy_tpu.ops import minima as ref_minima
from sassy_tpu.ops import myers_xla
from sassy_tpu.ops.myers_pallas import get_pallas_scan, get_pallas_scan_q2
from sassy_tpu_torch import profiles, semantics
from sassy_tpu_torch.ops import minima, myers_cuda, plan
from sassy_tpu_torch.ops.myers_torch import (
    PreparedText,
    TorchEngine,
    build_windows,
    overlay_n_tail,
)
from test_torch_cuda import _random_inputs, _random_q_inputs

BASES = np.frombuffer(b"ACGT", np.uint8)
OUT = ("vp", "vm", "cost")


def _np(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _u(t):
    """An int32 torch tensor of bit words as the JAX functions take it."""
    return jnp.asarray(t.numpy().view(np.uint32))


def _assert_equal(got, want, names=OUT):
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w), err_msg=name)


def _planted(seed, n, pattern, ends=True, copies=3, sub=2):
    """Random ACGT text of length n holding mutated copies of ``pattern``,
    and with ``ends`` a copy hanging off each end of the text."""
    rng = np.random.default_rng(seed)
    text = rng.choice(BASES, n)
    m = len(pattern)
    for i in range(copies):
        c = pattern.copy()
        c[rng.integers(0, m, sub)] = rng.choice(BASES, sub)
        at = (i + 1) * n // (copies + 2)
        text[at : at + m] = c
    if ends:
        h = m // 3
        text[: m - h] = pattern[h:]
        text[n - (m - h) :] = pattern[: m - h]
    return text


# ---------------------------------------------------------------------------
# the 'N' overlay and the window cache


@pytest.mark.parametrize("n,steps", [(0, 5), (31, 1), (32, 40), (100, 96),
                                     (1000, 33), (1023, 200)])
def test_overlay_n_tail_equals_reference(n, steps):
    rng = np.random.default_rng(n + steps)
    gw = (n + steps) // 32 + 4
    planes = rng.integers(0, 2**32, (4, gw), dtype=np.uint64).astype(np.uint32)
    e = n + steps
    want = myers_xla._kernels()["overlay"](
        jnp.asarray(planes), np.int32(n // 32), np.int32(n % 32),
        np.int32(e // 32), np.int32(e % 32),
    )
    got = overlay_n_tail(torch.from_numpy(planes.view(np.int32)), n, e)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("prof_name", ["iupac", "ascii"])
@pytest.mark.parametrize("steps", [7, 101])
def test_planes_for_equals_reference(prof_name, steps):
    rng = np.random.default_rng(steps)
    text = rng.choice(np.frombuffer(b"ACGTNRY", np.uint8), 2001)
    want = myers_xla.PreparedText(ref_profiles.get_profile(prof_name),
                                  text).planes_for(steps)
    got = PreparedText(profiles.get_profile(prof_name), text, "cpu")
    np.testing.assert_array_equal(got.planes_for(steps).numpy(), _np(want))
    # the plain planes are not touched by the overlay
    np.testing.assert_array_equal(
        got.planes.numpy(),
        _np(myers_xla.PreparedText(ref_profiles.get_profile(prof_name),
                                   text).planes))


def test_window_cache_is_keyed_by_steps(monkeypatch):
    """A search without overhang, then with it, on one PreparedText: the
    second must not reuse the first one's windows (built from planes
    without the overlay)."""
    monkeypatch.setattr(plan, "H100_TARGET_TILES", 8)
    prof = profiles.Iupac()
    pat = np.random.default_rng(1).choice(BASES, 40)
    text = _planted(2, 3000, pat)
    codes = prof.encode(pat)
    eng = TorchEngine("cpu")
    prep = eng.prepare(prof, text)
    for alpha in (None, 0.5, 0.0, None, 0.5):
        got = eng.candidates(prof, codes, prep, 4, alpha, None, False)
        fresh = eng.candidates(prof, codes, text, 4, alpha, None, False)
        want = myers_xla.XlaEngine().candidates(
            ref_profiles.Iupac(), codes, text, 4, alpha, None, False)
        assert got == fresh == sorted(want), alpha
    # one plan, two step counts: two cache entries with different windows
    w0 = prep.windows(7, 16, 2)
    w1 = prep.windows(7, 16, 2, steps=40)
    assert not torch.equal(w0, w1)
    assert torch.equal(w0, build_windows(prep.planes, 7, 16, 2))
    assert torch.equal(w1, build_windows(prep.planes_for(40), 7, 16, 2))


# ---------------------------------------------------------------------------
# the plain q1 and q2 kernels


def _jax_scan_args(args):
    """(windows, tile0, pmasks, is_pad, h_init, ...) as the JAX functions
    take them."""
    win, tile0, pm, ip, hi = args[:5]
    return (_u(win), jnp.asarray(tile0.numpy()), _u(pm), _u(ip), _u(hi))


def _q1_args(eq_mode, M, T, NW, seed):
    """The q1 kernel's inputs: q1meta's without the owned range and k."""
    a = _random_inputs(eq_mode, M=M, T=T, NW=NW, seed=seed)
    return (a[0], a[1], a[4], a[5], a[6], a[7], a[8], eq_mode)


def _q2_args(eq_mode, Q, M, T, NW, seed):
    a = _random_q_inputs(eq_mode, Q, M, T=T, NW=NW, seed=seed)
    return (a[0], a[1], a[4], a[5], a[6], a[7], a[8], eq_mode)


@pytest.mark.parametrize("eq_mode", ["iupac", "ascii"])
def test_q1_plain_equals_pallas_interpret(eq_mode):
    """The Pallas q1 kernel itself, in interpret mode at one (8, 128) lane
    group: T = 1024 tiles, NW = 3 words, M = 8 rows."""
    args = _q1_args(eq_mode, M=8, T=1024, NW=3, seed=21)
    win, tile0, pm, ip, hi, m_real, bm, _ = args
    NW, P, T = win.shape
    call = get_pallas_scan(eq_mode, P, 8, NW, True)
    outs = call(
        jnp.asarray(win.numpy()).reshape(NW, P, 1, 8, 128)
        .transpose(2, 0, 1, 3, 4),
        jnp.asarray(tile0.numpy().astype(np.int32).reshape(1, 8, 128)),
        jnp.asarray(pm.numpy()), jnp.asarray(ip.numpy()),
        jnp.asarray(hi.numpy()), jnp.int32(m_real), jnp.int32(bm),
    )
    want = [np.asarray(o).transpose(1, 0, 2, 3).reshape(NW, T) for o in outs]
    _assert_equal(myers_cuda.scan_plain(*args), want)


@pytest.mark.parametrize("eq_mode", ["iupac", "pure", "ascii"])
@pytest.mark.parametrize("M", [24, 120])
def test_q1_plain_equals_xla_twin(eq_mode, M):
    """``_scan_win`` on the XLA backend (the Pallas kernel's bits by
    construction) at the barcode shape and the position-level path's
    120 bp patterns (past the kernel's register rows)."""
    args = _q1_args(eq_mode, M=M, T=64, NW=5, seed=M + 1)
    want = myers_xla._kernels()["scan_win"](
        *_jax_scan_args(args), args[5], args[6],
        "ascii" if eq_mode == "ascii" else "iupac", "xla", False,
    )
    _assert_equal(myers_cuda.scan(*args), want)  # CPU: the plain version


@pytest.mark.parametrize("eq_mode,Q", [("iupac", 2), ("ascii", 3)])
def test_q2_plain_equals_pallas_interpret(eq_mode, Q):
    """The Pallas q2 kernel itself, in interpret mode at one (8, 128) lane
    group. It takes an even Q (an odd one is padded with a copy of the
    last pattern, as the JAX package pads it) and ascii masks as wide as
    the windows' 9 planes."""
    args = _q2_args(eq_mode, Q, M=8, T=1024, NW=3, seed=31)
    win, tile0, pm, ip, hi, m_real, bm, _ = args
    NW, P, T = win.shape
    pm = pm.numpy()
    if eq_mode == "ascii":
        pm = np.concatenate([pm, np.zeros((Q, 8, 1), np.int32)], axis=2)

    def even(a):
        a = np.asarray(a)
        return jnp.asarray(np.concatenate([a, a[-1:]]) if Q % 2 else a)

    call = get_pallas_scan_q2(eq_mode, P, 8, NW, True)
    outs = call(
        jnp.asarray(win.numpy()).reshape(NW, P, 1, 8, 128)
        .transpose(2, 0, 1, 3, 4),
        jnp.asarray(tile0.numpy().astype(np.int32).reshape(1, 8, 128)),
        even(pm), even(ip.numpy()), even(hi.numpy()),
        even(np.stack([m_real.numpy(), bm.numpy()], 1)),
    )
    want = [np.asarray(o)[:Q].transpose(0, 2, 1, 3, 4).reshape(Q, NW, T)
            for o in outs]
    _assert_equal(myers_cuda.scan_q_plain(*args), want)


@pytest.mark.parametrize("eq_mode", ["iupac", "pure", "ascii"])
@pytest.mark.parametrize("M", [24, 120])
def test_q2_plain_equals_xla_path(eq_mode, M):
    """``_scan_win_q`` on the XLA backend, odd Q, mixed m_real in one row
    bucket; each pattern's slice also equals the plain q1."""
    Q = 3
    args = _q2_args(eq_mode, Q, M=M, T=48, NW=4, seed=M + 7)
    assert len(set(args[5].tolist())) > 1
    want = myers_xla._kernels()["scan_win_q"](
        *_jax_scan_args(args), jnp.asarray(args[5].numpy()),
        jnp.asarray(args[6].numpy()),
        "ascii" if eq_mode == "ascii" else "iupac", "xla", False,
    )
    got = myers_cuda.scan_q(*args)  # CPU: the plain version
    _assert_equal(got, want)
    for q in range(Q):
        one = myers_cuda.scan_plain(*args[:2], args[2][q], args[3][q],
                                    args[4][q], int(args[5][q]),
                                    int(args[6][q]), eq_mode)
        for a, b in zip(one, got):
            assert torch.equal(a, b[q])


@pytest.mark.parametrize("which", ["scan", "scan_q"])
def test_cpu_tensors_take_the_plain_q1_q2(which):
    fn = getattr(myers_cuda, which)
    before = fn.launches
    if which == "scan":
        args = _q1_args("pure", M=16, T=32, NW=3, seed=2)
        want = myers_cuda.scan_plain(*args)
    else:
        args = _q2_args("pure", 2, M=16, T=32, NW=3, seed=2)
        want = myers_cuda.scan_q_plain(*args)
    _assert_equal(fn(*args), want)
    assert fn.launches == before


@pytest.mark.parametrize("which", ["scan", "scan_q"])
def test_q1_q2_take_no_other_device(which):
    win = torch.empty((3, 4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        getattr(myers_cuda, which)(win, *([torch.empty(0)] * 6), "iupac")


# ---------------------------------------------------------------------------
# the position-level selections


#: a k per alpha that makes a 120 bp pattern's overshoot span more than
#: three words (n_prev 5): the position-level path
POSITION_LEVEL_K = {0.1: 10, 0.3: 40, 0.7: 70}


@functools.lru_cache(maxsize=None)
def _position_level_scan(alpha, all_minima):
    """A position-level single search's inputs (120 bp) and its plain q1
    outputs, on a text whose mutated copies give many candidates."""
    prof = profiles.Iupac()
    rng = np.random.default_rng(int(alpha * 10))
    pat = rng.choice(BASES, 120)
    text = _planted(3, 1500, pat, copies=6, sub=3)
    eng = TorchEngine("cpu")
    inp = eng.build_inputs(prof, prof.encode(pat), text,
                           POSITION_LEVEL_K[alpha], alpha, None, all_minima)
    assert not inp.fast
    return text, inp, eng.scan(inp)


@pytest.mark.parametrize("all_minima", [False, True])
@pytest.mark.parametrize("alpha", [0.1, 0.3, 0.7])
@pytest.mark.parametrize("chunk", [None, 1, 3 * 1024])
def test_select_candidates_equals_reference(alpha, all_minima, chunk,
                                            monkeypatch):
    """The reference's position-level path (``_scan_flat`` over the
    overlaid planes, then ``minima.select_candidates``) against the plain
    q1 and the port's chunked selection; chunks of one tile and of a few
    tiles change nothing."""
    monkeypatch.setattr(plan, "H100_TARGET_TILES", 8)
    if chunk is not None:
        monkeypatch.setattr(minima, "POSITIONS_PER_CHUNK", chunk)
    text, inp, (vp, vm, cost) = _position_level_scan(alpha, all_minima)
    k, T, W, halo = inp.k, inp.windows.shape[2], inp.W, inp.halo
    ref_prep = myers_xla.PreparedText(ref_profiles.Iupac(), text)
    steps = inp.max_pos - inp.n_text
    ker = myers_xla._kernels()
    flat_costs, flat_delta = ker["scan_raw"](
        ref_prep.planes_for(steps), _u(inp.pmasks), _u(inp.is_pad),
        _u(inp.h_init), inp.m_real, inp.boundary_m, "iupac", T, W, halo,
        "xla", False,
    )
    cap = T * W * 32 + 1
    packed = np.asarray(ref_minima.select_candidates(
        jax, jnp, flat_costs, flat_delta, inp.boundary_m, inp.n_text,
        inp.max_pos, k, jnp.float32(alpha), all_minima, cap, cap,
    ))
    count = int(packed[0])
    want = list(zip(packed[2 : 2 + count].tolist(),
                    packed[2 + cap : 2 + cap + count].tolist()))
    assert len(want) > 5
    got = minima.select_candidates(
        vp, vm, cost, W, halo, inp.boundary_m, inp.n_text, inp.max_pos, k,
        alpha, all_minima,
    )
    assert list(zip(*got.tolist())) == want


def _piece_tables(rng, T, NW, with_starts):
    """Random piece tables of the batched engine's layout."""
    tile0 = rng.random(T) < 0.3 if with_starts else np.zeros(T, bool)
    vf = np.where(tile0, -1, rng.integers(0, 64, T)).astype(np.int32)
    vt = np.minimum(vf + rng.integers(32, NW * 32, T), NW * 32 - 32)
    vt = vt.astype(np.int32)
    tend = (vt - rng.integers(0, 60, T)).astype(np.int32)
    islast = np.where(rng.random(T) < 0.5, vt, -1).astype(np.int32)
    return tile0, vf, vt, tend, islast


@pytest.mark.parametrize("all_minima", [False, True])
@pytest.mark.parametrize("alpha", [0.0, 0.1, 0.5])
def test_select_candidates_tiles_equals_reference(alpha, all_minima):
    """Per-piece position-level selection of Q patterns over random q2
    outputs and piece tables, each pattern against the reference's."""
    Q, T, NW, k = 3, 40, 4, 6
    rng = np.random.default_rng(int(alpha * 10) + all_minima)
    tile0, vf, vt, tend, islast = _piece_tables(rng, T, NW, True)
    args = _q2_args("iupac", Q, M=24, T=T, NW=NW, seed=5)
    args = (args[0], torch.from_numpy(tile0), *args[2:])
    vp, vm, cost = myers_cuda.scan_q_plain(*args)
    m_real, bm = args[5], args[6]
    boundary0 = torch.where(torch.from_numpy(tile0)[None], bm[:, None],
                            m_real[:, None])
    state0 = rng.integers(0, 2, (Q, T)).astype(np.int32)
    pos_base = np.arange(T, dtype=np.int64) * (NW * 32 + 1)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    got = minima.select_candidates_tiles(
        vp, vm, cost, boundary0, t(tend), t(vf), t(vt), t(islast),
        t(pos_base), k, alpha, t(state0), all_minima,
    ).tolist()
    got = sorted(zip(*got))
    want = []
    cap = T * (NW * 32 + 1)
    for q in range(Q):
        packed = np.asarray(ref_minima.select_candidates_tiles(
            jax, jnp, _u(vp[q]), _u(vm[q]), jnp.asarray(cost[q].numpy()),
            jnp.asarray(boundary0[q].numpy()), jnp.asarray(tend),
            jnp.asarray(vf), jnp.asarray(vt), jnp.asarray(islast),
            jnp.asarray(pos_base.astype(np.int32)), k, jnp.float32(alpha),
            jnp.asarray(state0[q]), all_minima, cap, cap,
        ))
        n = int(packed[0])
        for p, c in zip(packed[2 : 2 + n].tolist(),
                        packed[2 + cap : 2 + cap + n].tolist()):
            want.append((q, p // (NW * 32 + 1), p, c))
    assert len(want) > 3
    assert got == sorted(want)


@pytest.mark.parametrize("Q", [1, 3])
def test_state_chain_from_raw_deltas_equals_reference(Q):
    """``last_delta_codes`` then ``tile_state_chain_codes``: the
    position-level paths' chain, from q1/q2 outputs without metadata,
    against the reference's ``tile_state_chain``."""
    T, NW = 300, 3
    rng = np.random.default_rng(Q)
    args = _q2_args("pure", Q, M=16, T=T, NW=NW, seed=Q)
    vp, vm, _ = myers_cuda.scan_q_plain(*args)
    # sparse deltas: many tiles own none
    keep = torch.from_numpy(rng.random((Q, NW, T)) < 0.2)
    vp, vm = vp * keep, vm * keep
    _, vf, vt, _, _ = _piece_tables(rng, T, NW, True)
    is_start = rng.random(T) < 0.05
    want = ref_minima.tile_state_chain(
        jax, jnp, _u(vp), _u(vm), jnp.asarray(vf), jnp.asarray(vt),
        jnp.asarray(is_start),
    )
    codes = minima.last_delta_codes(vp, vm, torch.from_numpy(vf),
                                    torch.from_numpy(vt))
    got = minima.tile_state_chain_codes(codes, torch.from_numpy(is_start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the meta kernels' `final` is the same code
    meta_args = _random_q_inputs("pure", Q, 16, T=T, NW=NW, seed=Q)
    _, final = minima.meta_from_words(vp, vm, torch.zeros_like(vp),
                                      torch.from_numpy(vf),
                                      torch.from_numpy(vt), meta_args[9])
    assert torch.equal(final, codes)


# ---------------------------------------------------------------------------
# the word-level selections with an overshoot strip


def _fast_overhang_inputs(m, k, alpha, seed, monkeypatch):
    """A fast-path overhang search's scan inputs and plain q1meta outputs:
    body tiles plus the tail tile."""
    monkeypatch.setattr(plan, "H100_TARGET_TILES", 8)
    prof = profiles.Iupac()
    rng = np.random.default_rng(seed)
    pat = rng.choice(BASES, m)
    text = _planted(seed, 1200, pat, copies=4, sub=1)
    inp = TorchEngine("cpu").build_inputs(prof, prof.encode(pat), text, k,
                                          alpha, None, False)
    assert inp.fast and inp.n_prev >= 2
    return inp, TorchEngine("cpu").scan(inp)


@pytest.mark.parametrize("all_minima", [False, True])
@pytest.mark.parametrize("m,k,alpha", [(24, 3, 0.5), (40, 4, 0.1),
                                       (30, 4, 0.3), (20, 5, 0.7),
                                       (80, 4, 0.05)])
def test_select_words_tiles_overhang_equals_reference(m, k, alpha,
                                                      all_minima,
                                                      monkeypatch):
    """``select_words_tiles`` with ``text_end``, ``alpha`` and ``n_prev``
    (n_prev 2 to 4) on the same scan outputs as the reference's."""
    inp, (vp, vm, cost, meta, final) = _fast_overhang_inputs(
        m, k, alpha, m + k, monkeypatch)
    T = vp.shape[1]
    state0 = (torch.zeros_like(final) if all_minima else
              minima.tile_state_chain_codes(final, inp.text_start))
    cap = vp.numel() * 33
    packed = np.asarray(ref_minima.select_words_tiles(
        jax, jnp, _u(vp), _u(vm), jnp.asarray(cost.numpy()),
        jnp.zeros((T,), jnp.int32), jnp.asarray(inp.valid_from.numpy()),
        jnp.asarray(inp.valid_to.numpy()), jnp.asarray(inp.islast.numpy()),
        jnp.asarray(inp.offset.numpy().astype(np.int32)), k,
        jnp.asarray(state0.numpy()), all_minima, cap, vp.numel(),
        meta=jnp.asarray(meta.numpy()),
        text_end=jnp.asarray(inp.text_end.numpy().astype(np.int32)),
        alpha=jnp.float32(alpha), n_prev=inp.n_prev,
    ))
    n = int(packed[0])
    want = sorted(zip(packed[2 : 2 + n].tolist(),
                      packed[2 + cap : 2 + cap + n].tolist()))
    assert want
    got = minima.select_words_tiles(
        vp, vm, cost, meta, inp.valid_from, inp.valid_to, inp.islast,
        inp.offset, k, state0, all_minima, inp.text_end, alpha, inp.n_prev,
    )
    assert sorted(zip(*got.tolist())) == want


@pytest.mark.parametrize("all_minima", [False, True])
@pytest.mark.parametrize("alpha,n_prev", [(0.5, 2), (0.1, 4)])
def test_select_words_tiles_q_overhang_equals_reference(alpha, n_prev,
                                                        all_minima):
    """``select_words_tiles_q`` with piece text ends, alpha and an
    ``n_prev`` strip, over random q2meta outputs of three patterns."""
    Q, T, NW, k = 3, 60, 8, 5
    rng = np.random.default_rng(n_prev)
    tile0, vf, vt, tend, islast = _piece_tables(rng, T, NW, True)
    a = _random_q_inputs("iupac", Q, 24, T=T, NW=NW, seed=9)
    args = (a[0], torch.from_numpy(tile0), torch.from_numpy(vf),
            torch.from_numpy(vt), *a[4:9], k, "iupac")
    vp, vm, cost, meta, final = myers_cuda.scan_q_meta_plain(*args)
    state0 = rng.integers(0, 2, (Q, T)).astype(np.int32)
    pos_base = np.arange(T, dtype=np.int64) * (NW * 32 + 1)
    cap, wcap = Q * NW * T * 33, Q * NW * T
    packed = np.asarray(ref_minima.select_words_tiles_q(
        jax, jnp, _u(vp), _u(vm), jnp.asarray(cost.numpy()),
        jnp.asarray(meta.numpy()), jnp.asarray(vf), jnp.asarray(vt),
        jnp.asarray(islast), jnp.asarray(pos_base.astype(np.int32)), k,
        jnp.asarray(state0), all_minima, cap, wcap,
        text_end=jnp.asarray(tend), alpha=jnp.float32(alpha), n_prev=n_prev,
    ))
    total = int(packed[0])
    pos = packed[3 : 3 + total]
    qc = packed[3 + cap : 3 + cap + total]
    cost16 = ((qc & 0xFFFF) ^ 0x8000) - 0x8000
    want = sorted(zip((qc >> 16).tolist(), pos.tolist(), cost16.tolist()))
    assert want
    q, tile, gpos, gcost = minima.select_words_tiles_q(
        vp, vm, cost, meta, torch.from_numpy(vf), torch.from_numpy(vt),
        torch.from_numpy(islast), torch.from_numpy(pos_base), k,
        torch.from_numpy(state0), all_minima, torch.from_numpy(tend), alpha,
        n_prev,
    ).tolist()
    assert all(p // (NW * 32 + 1) == t for p, t in zip(gpos, tile))
    assert sorted(zip(q, gpos, gcost)) == want


# ---------------------------------------------------------------------------
# the overshoot cost in float32


@pytest.mark.parametrize("alpha", [0.1, 0.3, 0.7])
def test_overshoot_cost_is_float32(alpha):
    """``floor(float32(alpha) * float32(overshoot))`` as the reference's
    ``semantics.overshoot_cost``, over every overshoot a pattern of up to
    400 chars can have. In float64 the product differs at alpha 0.7 (at
    overshoot 10: 6, where float32 gives 7); at 0.1 and 0.3 float64 happens
    to agree in this range."""
    over = torch.arange(-5, 400, dtype=torch.int64)
    got = minima.overshoot_floor(torch.tensor(alpha, dtype=torch.float32),
                                 over)
    want = [semantics.overshoot_cost(alpha, int(o)) for o in over]
    assert got.tolist() == want
    f64 = torch.floor(float(np.float32(alpha)) * over.clamp(min=0).double())
    differs = (f64.to(torch.int64) != got).nonzero().flatten().tolist()
    if alpha == 0.7:
        assert over[differs[0]] == 10 and got[differs[0]] == 7
    else:
        assert not differs


@pytest.mark.parametrize("n,width", [(1, 4), (5, 4), (8, 4), (1000, 16),
                                     (4099, 1024), (3, 1024)])
def test_cummax_1d_equals_torch_cummax(n, width):
    """The two-level running maximum of the position-level selection."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(-50, 10 * n, n))
    x[rng.random(n) < 0.5] = -1
    assert torch.equal(minima.cummax_1d(x, width),
                       torch.cummax(x, dim=0).values)
