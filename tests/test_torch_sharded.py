"""The port's sharded search (``sassy_tpu_torch.parallel``) on the CPU:
against the JAX ``ShardedSearch(backend="xla")`` on the 8-virtual-device
mesh of conftest.py, against the port's single engine and the numpy
oracle, with the owner-computes statistics checked. Its parts (the
prefilter, the mesh, the pack, the selection pieces) are
tests/test_torch_sharded_parts.py.

One process holds every slot of the port's mesh here (``make_mesh(...,
device="cpu")``), so the kernels run as their plain versions; the
multi-process runs are tests/test_torch_multihost.py.
"""

import numpy as np
import pytest

from sassy_tpu import profiles as ref_profiles
from sassy_tpu.parallel import ShardedSearch as RefShardedSearch
from sassy_tpu.parallel import make_mesh as ref_make_mesh
from sassy_tpu.search import NumpyEngine
from sassy_tpu_torch import graft_entry, profiles
from sassy_tpu_torch.ops import plan
from sassy_tpu_torch.ops.myers_torch import TorchEngine
from sassy_tpu_torch.parallel import ShardedSearch, make_mesh

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
PROF = profiles.Iupac()
REF_PROF = ref_profiles.Iupac()
ENGINE = TorchEngine("cpu")


def _ref(n_text, n_pat=1):
    return RefShardedSearch(mesh=ref_make_mesh(n_text=n_text, n_pat=n_pat),
                            cap=1 << 12, bcap=1 << 10, backend="xla")


def _port(n_text, n_pat=1, hier=None):
    return ShardedSearch(mesh=make_mesh(n_text, n_pat, device="cpu"),
                         hier=hier)


def _single(pats, text, k, alpha=None, all_minima=False, prof=PROF):
    return [ENGINE.candidates(prof, prof.encode(p), text, k, alpha, None,
                              all_minima) for p in pats]


def _oracle(pats, text, k, alpha=None, all_minima=False):
    eng = NumpyEngine()
    return [eng.candidates(REF_PROF, REF_PROF.encode(p), text, k, alpha, None,
                           all_minima) for p in pats]


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(map(tuple, a)) == sorted(map(tuple, b)), (
            sorted(set(a) ^ set(map(tuple, b)))[:8])


def _owner_checks(ss, got, want, n, steps):
    """The owner-computes invariants of ``last_stats``."""
    assert graft_entry.check_sharded_case(ss, got, want, n, steps) == sum(
        len(c) for c in want)


@pytest.mark.parametrize("n_text,n_pat", [(8, 1), (4, 2), (2, 1), (1, 1)])
def test_sharded_equals_reference(n_text, n_pat):
    """tests/test_sharded.py's seeds and trials: the port's lists equal the
    JAX sharded search's exactly, on the same mesh shape."""
    ref = _ref(n_text, n_pat)
    port = _port(n_text, n_pat)
    rng = np.random.default_rng(n_text * 10 + n_pat)
    for trial in range(4):
        n = int(rng.integers(200, 3000))
        m = int(rng.integers(5, 40))
        k = int(rng.integers(0, 5))
        all_minima = bool(rng.integers(0, 2))
        alpha = [None, 0.5, 0.3][trial % 3]
        text = rng.choice(BASES, size=n)
        pats = [rng.choice(BASES, size=m) for _ in range(3)]
        text[50 : 50 + m] = pats[0]
        want = ref.candidates_batch(REF_PROF, pats, text, k, alpha=alpha,
                                    all_minima=all_minima)
        got = port.candidates_batch(PROF, pats, text, k, alpha=alpha,
                                    all_minima=all_minima)
        _same(got, want)
        _same(got, _single(pats, text, k, alpha, all_minima))
        assert port.last_stats["ownership_violations"] == 0


def test_sharded_dna_profile_equals_reference():
    rng = np.random.default_rng(7)
    text = rng.choice(BASES, size=1000)
    pats = [rng.choice(BASES, size=12) for _ in range(2)]
    want = _ref(4).candidates_batch(ref_profiles.Dna(), pats, text, 2)
    got = _port(4).candidates_batch(profiles.Dna(), pats, text, 2)
    _same(got, want)
    _same(got, _single(pats, text, 2, prof=profiles.Dna()))


def _edge_text(rng, Dt, m, k, n_pats, tail=0):
    """A text of exactly Dt shards of S = H + 3 words (less ``tail``
    chars), the shard length the search will choose, with one copy of a
    pattern (one substitution) ending inside each shard's first H words."""
    M = plan._bucket_rows(m)
    H = plan.next_pow2(plan.cdiv(M + k, 32))
    S = H + 3
    n = S * 32 * Dt - tail
    text = rng.choice(BASES, size=n)
    pats = [rng.choice(BASES, size=m) for _ in range(n_pats)]
    ends = []
    for d in range(1, Dt):
        end = d * S * 32 + int(rng.integers(1, H * 32))
        copy = pats[d % n_pats].copy()
        copy[m // 2] = BASES[(BASES.tolist().index(copy[m // 2]) + 1) % 4]
        text[end - m : end] = copy
        ends.append((d % n_pats, end))
    return text, pats, ends, S


@pytest.mark.parametrize("n_text,n_pat", [(4, 1), (4, 2)])
def test_match_across_a_shard_edge(n_text, n_pat):
    """A copy ending in the next shard's first H words (the halo) is found
    once, by the shard that owns its end, with its cost."""
    rng = np.random.default_rng(40 + n_pat)
    m, k = 23, 3
    text, pats, ends, S = _edge_text(rng, n_text, m, k, 3)
    port = _port(n_text, n_pat)
    got = port.candidates_batch(PROF, pats, text, k)
    assert port.last_stats["S"] == S
    for q, end in ends:
        assert (end, 1) in got[q]
    want = _ref(n_text, n_pat).candidates_batch(REF_PROF, pats, text, k)
    _same(got, want)
    _owner_checks(port, got, want, len(text), 0)


def _plateau(rng, m, alpha_tail):
    """Eight shards with a run of 'A' across the start of a random one and
    an all-'A' pattern: a plateau of equal costs whose rightmost end the
    decreasing state has to carry across shard edges; with ``alpha_tail``
    the text also ends in 'A'."""
    S = plan.next_pow2(plan.cdiv(plan._bucket_rows(m) + 3, 32)) + 2
    text = rng.choice(BASES, size=S * 32 * 8 - 17)
    edge = S * 32 * int(rng.integers(1, 8))
    text[max(0, edge - 120) : edge + 150] = ord("A")
    if alpha_tail:
        text[-(m // 2):] = ord("A")
    return text, [np.full(m, ord("A"), np.uint8), rng.choice(BASES, size=m)]


@pytest.mark.parametrize("all_minima", [False, True])
def test_plateau_across_an_edge_equals_reference(all_minima):
    """The word-level path: the cross-shard state chain selects the
    plateau's rightmost end as one device does."""
    rng = np.random.default_rng(3)
    text, pats = _plateau(rng, 14, False)
    got = _port(8).candidates_batch(PROF, pats, text, 2,
                                    all_minima=all_minima)
    _same(got, _ref(8).candidates_batch(REF_PROF, pats, text, 2,
                                        all_minima=all_minima))
    _same(got, _oracle(pats, text, 2, None, all_minima))


@pytest.mark.parametrize("seed", [2, 11, 21])
def test_overhang_plateau_across_edges_equals_oracle(seed):
    """The position-level path chains the state by shard index, as the
    word-level path does. The reference's overhang chain orders shards by
    the window-local position of their last delta (``sharded.py:460-473``)
    and misses these plateau ends (ROADMAP Queue 3 item 3), so the port
    is held to the numpy oracle and to its single engine."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(10, 18))
    alpha = [0.5, 0.3][seed % 2]
    text, pats = _plateau(rng, m, True)
    got = _port(8).candidates_batch(PROF, pats, text, 1, alpha=alpha)
    _same(got, _oracle(pats, text, 1, alpha))
    _same(got, _single(pats, text, 1, alpha))
    ref = _ref(8).candidates_batch(REF_PROF, pats, text, 1, alpha=alpha)
    assert any(sorted(a) != sorted(b) for a, b in zip(got, ref))


@pytest.mark.parametrize("alpha", [None, 0.5])
def test_uneven_tail_leaves_trailing_shards_idle(alpha):
    rng = np.random.default_rng(11)
    text = rng.choice(BASES, size=150)
    pats = [rng.choice(BASES, size=16) for _ in range(4)]
    text[-16:] = pats[1]
    port = _port(8)
    got = port.candidates_batch(PROF, pats, text, 3, alpha=alpha)
    want = _ref(8).candidates_batch(REF_PROF, pats, text, 3, alpha=alpha)
    _same(got, want)
    steps = 0 if alpha is None else 4
    _owner_checks(port, got, want, len(text), steps)
    assert port.last_stats["owned_words"][-1] == 0


def test_pattern_count_not_divisible_by_the_pattern_axis():
    """Q = 3 on a 2-group pattern axis: the repeats of pattern 0 that pad
    it are dropped from the lists and from the counts."""
    rng = np.random.default_rng(12)
    text = rng.choice(BASES, size=2000)
    pats = [rng.choice(BASES, size=12) for _ in range(3)]
    for i, p in enumerate(pats):
        text[300 + 500 * i : 312 + 500 * i] = p
    port = _port(4, 2)
    got = port.candidates_batch(PROF, pats, text, 2)
    want = _ref(4, 2).candidates_batch(REF_PROF, pats, text, 2)
    _same(got, want)
    stats = port.last_stats
    assert (stats["Dp"], stats["Qlocal"]) == (2, 2)
    _owner_checks(port, got, want, len(text), 0)
