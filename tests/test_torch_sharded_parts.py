"""The parts of the port's sharded search on the CPU: the suffix prefilter
forced on and off and its gate, the profiles and lengths it refuses, the
mesh, the sharded text's pack, the owner-computes statistics, and the two
selection pieces the shards chain with (the seeded state chain and the
owned position-level selection) against the reference's ``minima``
functions. The searches against the JAX sharded search are
tests/test_torch_sharded.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sassy_tpu.ops import minima as ref_minima
from sassy_tpu_torch import profiles
from sassy_tpu_torch.ops import minima, plan
from sassy_tpu_torch.parallel import ShardedSearch, ShardedText, make_mesh
from sassy_tpu_torch.parallel import sharded
from test_torch_sharded import (
    BASES,
    PROF,
    REF_PROF,
    _oracle,
    _owner_checks,
    _port,
    _ref,
    _same,
    _single,
)


def test_prefilter_forced_on_equals_off(monkeypatch):
    """80 bp at k=2 (32 suffix rows) over 8 shards: the suffix prefilter
    forced on (it flags the tiles of the planted copies only) returns the
    lists of the forced-off run, the reference's and the oracle's."""
    rng = np.random.default_rng(123)
    m, k = 80, 2
    text = rng.choice(BASES, size=4000)
    pats = [rng.choice(BASES, size=m) for _ in range(2)]
    text[100 : 100 + m] = pats[0]
    text[2000 : 2000 + m] = pats[1]
    text[3100 : 3100 + m] = pats[1]
    runs = []
    real = ShardedSearch._prefilter
    monkeypatch.setattr(ShardedSearch, "_prefilter",
                        lambda self, *a: runs.append(1) or real(self, *a))
    for n_pat, allm in ((1, False), (2, True)):
        on = _port(4, n_pat, hier=True).candidates_batch(
            PROF, pats, text, k, all_minima=allm)
        off = _port(4, n_pat, hier=False).candidates_batch(
            PROF, pats, text, k, all_minima=allm)
        _same(on, off)
        _same(on, _oracle(pats, text, k, None, allm))
    assert len(runs) == 4 + 8  # once a slot
    _same(on, _ref(4).candidates_batch(REF_PROF, pats, text, k,
                                       all_minima=True))


def test_prefilter_gate_and_a_slot_with_no_flagged_tile(monkeypatch):
    """The gate is the port's one (``plan.HIER_MIN_SAVED_PAIRS``); a slot
    whose tiles are all unflagged returns nothing and passes the state on."""
    rng = np.random.default_rng(5)
    text = rng.choice(BASES, size=4000)
    pat = rng.choice(BASES, size=80)
    text[3500:3580] = pat
    runs = []
    real = ShardedSearch._prefilter
    monkeypatch.setattr(ShardedSearch, "_prefilter",
                        lambda self, *a: runs.append(1) or real(self, *a))
    got = _port(4).candidates_batch(PROF, [pat], text, 2)
    assert runs == []
    monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", 0)
    assert _port(4).candidates_batch(PROF, [pat], text, 2) == got
    assert len(runs) == 4 and got[0] and got == _single([pat], text, 2)


def test_ascii_and_unequal_lengths_raise():
    port = _port(2)
    with pytest.raises(NotImplementedError):
        port.candidates_batch(profiles.Ascii(), [b"abc"], b"xxabcxx", 0)
    with pytest.raises(ValueError, match="equal-length"):
        port.candidates_batch(PROF, [b"ACGT", b"ACG"], b"ACGTACGT", 0)


def test_mesh_layout_and_default_device():
    mesh = make_mesh(4, 2, device="cpu")
    assert (mesh.shape, mesh.size, list(mesh.slots)) == (
        {"pat": 2, "text": 4}, 8, list(range(8)))
    assert make_mesh(device="cpu").shape == {"pat": 1, "text": 1}
    with pytest.raises(ValueError):
        make_mesh(0, 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedSearch()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(2)


def test_sharded_text_packs_only_the_shards_asked_and_memoises():
    rng = np.random.default_rng(2)
    text = rng.choice(np.frombuffer(b"ACGTRYN", np.uint8), size=1000)
    st = ShardedText(PROF, text)
    got = st.planes_sharded(4, 9, 5, [1, 3], "cpu")
    assert sorted(got) == [1, 3]
    assert st.planes_sharded(4, 9, 5, [3, 1], "cpu") is got
    # the reference's pack of the whole text, shards 1 and 3
    codes = np.concatenate([PROF.encode(text), np.full(5, 15, np.uint8)])
    from sassy_tpu.ops.bitpack import pack_planes_np
    want = pack_planes_np(codes, 4, 4 * 9).reshape(4, 4, 9)
    for d in (1, 3):
        np.testing.assert_array_equal(got[d].numpy().view(np.uint32),
                                      want[:, d])
    for i in range(8):
        st.planes_sharded(4, 9, i, [0], "cpu")
    assert len(st._memo) <= 8
    # a tensor text packs the same planes
    t = ShardedText(PROF, torch.from_numpy(text.copy()))
    assert torch.equal(t.planes_sharded(4, 9, 5, [1], "cpu")[1], got[1])


@pytest.mark.parametrize("alpha", [None, 0.5])
def test_owner_computes_statistics_by_the_dryrun_check(alpha):
    rng = np.random.default_rng(21)
    text = rng.choice(BASES, size=4 * 512 + 37)
    pats = [rng.choice(BASES, size=10) for _ in range(4)]
    for i in range(4):
        text[400 * i + 90 : 400 * i + 100] = pats[i]
    port = _port(4, 2)
    got = port.candidates_batch(PROF, pats, text, 2, alpha=alpha)
    want = _single(pats, text, 2, alpha)
    _owner_checks(port, got, want, len(text), 0 if alpha is None else 4)
    assert sum(map(len, want)) >= 4
    # a count moved to another shard breaks the check
    port.last_stats["per_shard_counts"][0, :2] += [1, -1]
    with pytest.raises(AssertionError):
        _owner_checks(port, got, want, len(text), 0 if alpha is None else 4)


def test_seeded_state_chain_equals_reference():
    rng = np.random.default_rng(8)
    Q, T = 5, 40
    tl = np.where(rng.random((Q, T)) < 0.4, 0,
                  2 + rng.integers(0, 2, (Q, T))).astype(np.int32)
    starts = rng.random(T) < 0.1
    seed = np.where(rng.random(Q) < 0.3, 0, 2 + rng.integers(0, 2, Q)
                    ).astype(np.int32)
    want, want_out = ref_minima.tile_state_chain_codes(
        jax, jnp, jnp.asarray(tl), jnp.asarray(starts),
        seed_code=jnp.asarray(seed), with_out=True)
    got, out = minima.tile_state_chain_codes(
        torch.from_numpy(tl), torch.from_numpy(starts),
        seed_code=torch.from_numpy(seed), with_out=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    # no seed: the old result
    np.testing.assert_array_equal(
        minima.tile_state_chain_codes(torch.from_numpy(tl),
                                      torch.from_numpy(starts)).numpy(),
        np.asarray(ref_minima.tile_state_chain_codes(
            jax, jnp, jnp.asarray(tl), jnp.asarray(starts))))


def _words_and_costs(rng, W, c0):
    """W random scan-like words (disjoint vp/vm) of one tile and their
    word-start costs from c0, with the flat per-position deltas."""
    r1, r2, r3 = (rng.integers(0, 2**32, W, dtype=np.uint64).astype(np.uint32)
                  for _ in range(3))
    vp, vm = r1 & r2, ~r1 & r3  # disjoint, no drift
    vp[rng.random(W) < 0.3] = 0
    vm[rng.random(W) < 0.3] = 0
    bits = np.arange(32, dtype=np.uint32)
    delta = (((vp[:, None] >> bits) & 1).astype(np.int32)
             - ((vm[:, None] >> bits) & 1).astype(np.int32)).reshape(-1)
    flat_cost = c0 + np.cumsum(delta)
    word_cost = np.concatenate([[c0], flat_cost[31::32][:-1]]).astype(np.int32)
    return (vp, vm, word_cost, delta.astype(np.int32),
            flat_cost.astype(np.int32))


@pytest.mark.parametrize("case", range(6))
def test_owned_position_selection_equals_reference(case):
    """``select_candidates`` with the shard's ``min_pos`` / ``owned_end`` /
    ``state0`` against the reference's, over one tile of random words
    (T = 1: the flat positions are the window's)."""
    rng = np.random.default_rng(100 + case)
    W = 12
    c0 = int(rng.integers(0, 20))
    vp, vm, wc, delta, fc = _words_and_costs(rng, W, c0)
    k = int(rng.integers(c0, c0 + 8))
    alpha = [None, 0.5, 0.3][case % 3]
    n_text = int(rng.integers(W * 16, W * 32))
    max_pos = n_text + (0 if alpha is None else int(rng.integers(0, 40)))
    min_pos = int(rng.integers(0, 64))
    owned_end = int(rng.integers(min_pos, W * 32))
    state0 = int(rng.integers(0, 2))
    bm = int(rng.integers(0, 8))
    packed = np.asarray(ref_minima.select_candidates(
        jax, jnp, jnp.asarray(fc), jnp.asarray(delta), bm, n_text, max_pos,
        k, np.float32(alpha or 0.0), False, 4096, 64, min_pos=min_pos,
        owned_end=owned_end, state0=jnp.int32(state0)))
    cnt = int(packed[0])
    want = sorted(zip(packed[2 : 2 + cnt].tolist(),
                      packed[2 + 4096 : 2 + 4096 + cnt].tolist()))
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.concatenate([a, a[:1] * 0]).view(np.int32)[:, None].copy())
    got = minima.select_candidates(
        t(vp), t(vm), t(wc), W, 0, bm,
        n_text, max_pos, k, alpha, False, min_pos=min_pos,
        owned_end=owned_end, state0=state0)
    assert sorted(map(tuple, got.T.tolist())) == want
    # the code of the last nonzero owned delta, as the shards chain it
    hi = min(owned_end, max_pos)
    p = np.arange(1, W * 32 + 1)
    ov = lambda x: np.floor(np.float32(alpha or 0) * np.maximum(  # noqa: E731
        x - n_text, 0).astype(np.float32)).astype(np.int64)
    adj = delta + ov(p) - ov(p - 1)
    nz = np.nonzero((adj != 0) & (p >= max(min_pos, 1)) & (p <= hi))[0]
    want_code = 0 if nz.size == 0 else 2 + int(adj[nz[-1]] > 0)
    assert minima.last_owned_code(t(vp), t(vm), W, 0, min_pos, hi, n_text,
                                  alpha) == want_code


def test_step_times_are_recorded():
    """Only a ``timed`` search records its steps; the lists are the same."""
    rng = np.random.default_rng(4)
    text = rng.choice(BASES, size=900)
    pats = [text[100:120].copy()]
    port = _port(2)
    got = port.candidates_batch(PROF, pats, text, 1)
    assert port.last_times == {}
    timed = ShardedSearch(mesh=make_mesh(2, 1, device="cpu"), timed=True)
    assert timed.candidates_batch(PROF, pats, text, 1) == got
    assert tuple(timed.last_times) == sharded.STEPS
    assert all(v >= 0 for v in timed.last_times.values())


def test_bench_sharded_runs_both_paths_at_both_shard_counts(capsys):
    from sassy_tpu_torch.tools import bench_sharded

    assert bench_sharded.main(["--mb", "0.004", "--reps", "1", "--device",
                               "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert [(c["Dt"], c["path"]) for c in out["cases"]] == [
        (1, "fast"), (1, "overhang"), (4, "fast"), (4, "overhang")]
    assert all(c["candidates"] >= 4 and c["best_ms"] > 0
               and c["timed_best_ms"] > 0
               and tuple(c["steps_ms"]) == sharded.STEPS
               for c in out["cases"])
    assert set(out["overhang_over_fast"]) == {"1", "4"}
