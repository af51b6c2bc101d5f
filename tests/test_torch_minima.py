"""The port's selection against the JAX package: the word min-prefix, the
per-word metadata, the cross-tile state chain, and the engine's candidate
lists against ``XlaEngine`` (whose tile plan differs from the port's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sassy_tpu import profiles as ref_profiles
from sassy_tpu.ops import minima as ref
from sassy_tpu.ops.myers_xla import XlaEngine
from sassy_tpu_torch import profiles
from sassy_tpu_torch.ops import minima, plan
from sassy_tpu_torch.ops.myers_torch import TorchEngine


def _words(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def test_word_min_prefix_equals_reference():
    rng = np.random.default_rng(0)
    vp = _words(rng, 4000)
    vm = _words(rng, 4000) & ~vp
    # edge words: all +1, all -1, empty
    vp[:3] = [0xFFFFFFFF, 0, 0]
    vm[:3] = [0, 0xFFFFFFFF, 0]
    want = ref.word_min_prefix(jax, jnp, jnp.asarray(vp), jnp.asarray(vm))
    got = minima.word_min_prefix(_t(vp), _t(vm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("disjoint", [True, False])
def test_meta_from_words_equals_reference(disjoint):
    """Exact for any words; scan outputs have disjoint vp/vm."""
    rng = np.random.default_rng(int(disjoint))
    NW, T = 9, 300
    vp = _words(rng, (NW, T))
    vm = _words(rng, (NW, T))
    if disjoint:
        vm &= ~vp
    # sparse words so some tiles have no owned delta at all
    vp[rng.random((NW, T)) < 0.3] = 0
    vm[rng.random((NW, T)) < 0.3] = 0
    cost = rng.integers(0, 40, (NW, T)).astype(np.int32)
    vf = np.where(rng.random(T) < 0.2, -1, rng.integers(0, 100, T)).astype(
        np.int32)
    vt = (vf + rng.integers(0, NW * 32 + 40, T)).astype(np.int32)
    k = 6
    want = ref.meta_from_words(jax, jnp, jnp.asarray(vp), jnp.asarray(vm),
                               jnp.asarray(cost), jnp.asarray(vf),
                               jnp.asarray(vt), k)
    got = minima.meta_from_words(_t(vp), _t(vm), torch.from_numpy(cost),
                                 torch.from_numpy(vf), torch.from_numpy(vt), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_tile_state_chain_codes_equals_reference():
    rng = np.random.default_rng(2)
    T = 5000
    tl = rng.choice(np.array([0, 2, 3], np.int32), T, p=[0.6, 0.2, 0.2])
    is_start = rng.random(T) < 0.01
    is_start[0] = True
    want = ref.tile_state_chain_codes(jax, jnp, jnp.asarray(tl),
                                      jnp.asarray(is_start))
    got = minima.tile_state_chain_codes(torch.from_numpy(tl),
                                        torch.from_numpy(is_start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # one pattern's row of T > 1024 tiles (cummax_1d's two levels), seeded
    tl1, seed = tl[None, :3000], np.array([3], np.int32)
    want = ref.tile_state_chain_codes(jax, jnp, jnp.asarray(tl1),
                                      jnp.asarray(is_start[:3000]),
                                      jnp.asarray(seed), True)
    got = minima.tile_state_chain_codes(torch.from_numpy(tl1),
                                        torch.from_numpy(is_start[:3000]),
                                        torch.from_numpy(seed), True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _planted(seed, n, m, alphabet):
    """Random text with the pattern planted exactly, mutated, and as two
    overlapping copies (flat-cost plateaus across tile borders)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(alphabet, np.uint8)
    pat = rng.choice(bases[:4], m)
    text = rng.choice(bases, n)
    for off in rng.integers(0, n - 2 * m, 12):
        text[off : off + m] = pat
        if off % 3 == 0:
            text[off + m // 2] = bases[(off // 3) % 4]
        if off % 5 == 0:
            text[off + m // 2 : off + m // 2 + m] = pat
    return pat, text


@pytest.mark.parametrize("all_minima", [False, True])
@pytest.mark.parametrize("prof_name,m,k,tiles", [
    ("dna", 23, 3, 40),
    ("iupac", 12, 1, 7),
    ("iupac", 30, 0, 100),
    ("dna", 23, 3, 3),
])
def test_candidates_equal_xla_engine(prof_name, m, k, tiles, all_minima,
                                     monkeypatch):
    prof = profiles.get_profile(prof_name)
    alphabet = b"ACGT" if prof_name == "dna" else b"ACGTNRY"
    pat, text = _planted(m * 7 + k, 6000, m, alphabet)
    codes = prof.encode(pat)
    want = XlaEngine().candidates(ref_profiles.get_profile(prof_name), codes,
                                  text, k, None, None, all_minima)
    monkeypatch.setattr(plan, "H100_TARGET_TILES", tiles)
    got = TorchEngine("cpu").candidates(
        prof, codes, text, k, None, None, all_minima
    )
    assert want, "the planted copies must give candidates"
    assert got == want
