"""The candidate selection's entry points and plain versions on the CPU.

``ops/minima.py``'s three selections (``select_words_tiles_q``,
``select_candidates``, ``select_candidates_tiles``) run their plain
versions for CPU tensors and their CUDA kernels (``csrc/select_words.cu``,
``csrc/select_positions.cu``) for CUDA tensors; the kernels are held to
the plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``. Here: the dispatch leaves the kernels' counters alone,
the plain versions equal the JAX package's selection where
``tests/test_torch_minima.py`` does not reach (the overshoot strip with
text ends, the sharded owned range and incoming state, long one-row state
chains), the engines do not depend on the order of the candidates a
selection returns, and the kernels' sources are built and hashed with the
scan kernels'. Exact equality: every output is an integer.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sassy_tpu import profiles as ref_profiles
from sassy_tpu.ops import minima as ref_minima
from sassy_tpu.ops import myers_xla
from sassy_tpu.ops.myers_xla import XlaEngine
from sassy_tpu_torch import diagnostics, profiles
from sassy_tpu_torch.ops import minima, myers_cuda, plan
from sassy_tpu_torch.ops.batch import BatchEngine
from sassy_tpu_torch.ops.myers_torch import TorchEngine
from sassy_tpu_torch.parallel import ShardedSearch, make_mesh
from test_torch_cuda import _random_q_inputs
from test_torch_overhang_ops import _piece_tables, _planted, _q2_args, _u

BASES = np.frombuffer(b"ACGT", np.uint8)
ENTRIES = {"select_words_tiles_q": "select_words_tiles_q_plain",
           "select_candidates": "select_candidates_plain",
           "select_candidates_tiles": "select_candidates_tiles_plain"}


def _word_args(Q=3, T=50, NW=6, k=5, seed=1, overhang=True):
    """Random q2meta outputs and piece tables: select_words_tiles_q's
    arguments (with text ends, alpha and a two-word strip)."""
    rng = np.random.default_rng(seed)
    tile0, vf, vt, tend, islast = _piece_tables(rng, T, NW, True)
    a = _random_q_inputs("iupac", Q, 24, T=T, NW=NW, seed=seed)
    t = torch.from_numpy
    vp, vm, cost, meta, _ = myers_cuda.scan_q_meta_plain(
        a[0], t(tile0), t(vf), t(vt), *a[4:9], k, "iupac")
    state0 = t(rng.integers(0, 2, (Q, T)).astype(np.int32))
    pos_base = t(np.arange(T, dtype=np.int64) * (NW * 32 + 1))
    return (vp, vm, cost, meta, t(vf), t(vt), t(islast), pos_base, k,
            state0, False, t(tend.astype(np.int64)) if overhang else None,
            0.3 if overhang else None, 2 if overhang else 0)


def _position_args():
    """A position-level single search's q1 outputs (120 bp, alpha 0.1):
    select_candidates' arguments."""
    plan_tiles = plan.H100_TARGET_TILES
    plan.H100_TARGET_TILES = 8
    try:
        prof = profiles.Iupac()
        rng = np.random.default_rng(1)
        pat = rng.choice(BASES, 120)
        text = _planted(3, 1500, pat, copies=6, sub=3)
        eng = TorchEngine("cpu")
        inp = eng.build_inputs(prof, prof.encode(pat), text, 10, 0.1, None,
                               False)
        vp, vm, cost = eng.scan(inp)
    finally:
        plan.H100_TARGET_TILES = plan_tiles
    assert not inp.fast
    return text, inp, (vp, vm, cost, inp.W, inp.halo, inp.boundary_m,
                       inp.n_text, inp.max_pos, inp.k, 0.1, False)


def _tile_args(Q=3, T=30, NW=4, k=6, alpha=0.1):
    """Random q2 outputs and piece tables: select_candidates_tiles'
    arguments."""
    rng = np.random.default_rng(Q)
    tile0, vf, vt, tend, islast = _piece_tables(rng, T, NW, True)
    args = _q2_args("iupac", Q, M=24, T=T, NW=NW, seed=5)
    args = (args[0], torch.from_numpy(tile0), *args[2:])
    vp, vm, cost = myers_cuda.scan_q_plain(*args)
    boundary0 = torch.where(torch.from_numpy(tile0)[None], args[6][:, None],
                            args[5][:, None])
    t = torch.from_numpy
    state0 = t(rng.integers(0, 2, (Q, T)).astype(np.int32))
    pos_base = t(np.arange(T, dtype=np.int64) * (NW * 32 + 1))
    return (vp, vm, cost, boundary0, t(tend.astype(np.int64)), t(vf), t(vt),
            t(islast), pos_base, k, alpha, state0, False)


def _kernel_counts():
    return (myers_cuda.select_words.launches,
            myers_cuda.select_positions.launches,
            myers_cuda.select_positions_tiles.launches)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_cpu_tensors_run_the_plain_version(entry):
    """On CPU tensors each entry point calls its plain version once and
    returns its result; no kernel counter moves."""
    args = {"select_words_tiles_q": _word_args,
            "select_candidates": lambda: _position_args()[2],
            "select_candidates_tiles": _tile_args}[entry]()
    plain = getattr(minima, ENTRIES[entry])
    kernels = _kernel_counts()
    calls = plain.calls
    got = getattr(minima, entry)(*args)
    assert plain.calls == calls + 1
    assert _kernel_counts() == kernels
    assert got.shape[1] > 0
    assert torch.equal(got, plain(*args))


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_other_devices_raise(entry):
    """Tensors on neither the CPU nor a CUDA device go to the kernel
    wrapper, which refuses them before any build or launch."""
    args = {"select_words_tiles_q": _word_args,
            "select_candidates": lambda: _position_args()[2],
            "select_candidates_tiles": _tile_args}[entry]()
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    with pytest.raises(ValueError, match="cpu or cuda"):
        getattr(minima, entry)(*meta)


def test_word_level_strip_candidates_equal_xla_engine(monkeypatch):
    """The single engine's word-level overhang path (the tail tile and
    ``n_prev`` strips of 2-4 words with text ends) against the JAX
    package's XLA engine, whose tile plan differs, both strands' worth of
    copies hanging off each end."""
    monkeypatch.setattr(plan, "H100_TARGET_TILES", 8)
    prof = profiles.Iupac()
    for m, k, alpha, seed in ((24, 3, 0.5, 1), (40, 4, 0.1, 2),
                              (30, 5, 0.3, 3)):
        rng = np.random.default_rng(seed)
        pat = rng.choice(BASES, m)
        text = _planted(seed, 1800, pat, copies=4, sub=1)
        text[: m - 3] = pat[3:]
        text[-(m - 4):] = pat[: m - 4]
        inp = TorchEngine("cpu").build_inputs(prof, prof.encode(pat), text,
                                              k, alpha, None, False)
        assert inp.fast and inp.n_prev >= 2 and inp.text_end is not None
        for all_minima in (False, True):
            want = XlaEngine().candidates(ref_profiles.Iupac(),
                                          prof.encode(pat), text, k, alpha,
                                          None, all_minima)
            got = TorchEngine("cpu").candidates(prof, prof.encode(pat), text,
                                                k, alpha, None, all_minima)
            assert want and got == want
            assert any(p == len(text) + 4 for p, _ in got)


@pytest.mark.parametrize("owned", [(0, None, 0), (700, 2900, 1),
                                   (700, 2900, 0), (1500, None, 1)])
def test_sharded_select_candidates_equals_reference(owned):
    """``select_candidates`` with the sharded search's owned range
    (``min_pos``, ``owned_end``) and incoming state ``state0`` against the
    reference's, on the same q1 outputs and the reference's flat costs."""
    min_pos, owned_end, state0 = owned
    text, inp, args = _position_args()
    T, W, halo = inp.windows.shape[2], inp.W, inp.halo
    ref_prep = myers_xla.PreparedText(ref_profiles.Iupac(), text)
    flat_costs, flat_delta = myers_xla._kernels()["scan_raw"](
        ref_prep.planes_for(inp.max_pos - inp.n_text), _u(inp.pmasks),
        _u(inp.is_pad), _u(inp.h_init), inp.m_real, inp.boundary_m, "iupac",
        T, W, halo, "xla", False,
    )
    cap = T * W * 32 + 1
    packed = np.asarray(ref_minima.select_candidates(
        jax, jnp, flat_costs, flat_delta, inp.boundary_m, inp.n_text,
        inp.max_pos, inp.k, jnp.float32(0.1), False, cap, cap,
        min_pos=jnp.int32(min_pos),
        owned_end=None if owned_end is None else jnp.int32(owned_end),
        state0=jnp.int32(state0),
    ))
    n = int(packed[0])
    want = list(zip(packed[2 : 2 + n].tolist(),
                    packed[2 + cap : 2 + cap + n].tolist()))
    got = minima.select_candidates(*args, min_pos=min_pos,
                                   owned_end=owned_end, state0=state0)
    assert list(zip(*got.tolist())) == want
    assert want


@pytest.mark.parametrize("shape", [(3000,), (1, 3000), (2, 1500), (1, 1)])
def test_long_single_row_chains_equal_reference(shape):
    """``tile_state_chain_codes`` over one long row (``cummax_1d``'s two
    levels, more than one 1024-element row of them) and over several rows
    (``torch.cummax``), seeded and not, with its outgoing code."""
    rng = np.random.default_rng(sum(shape))
    tl = rng.choice(np.array([0, 2, 3], np.int32), shape, p=[0.7, 0.15,
                                                             0.15])
    is_start = rng.random(shape[-1]) < 0.002
    seed = rng.choice(np.array([0, 2, 3], np.int32), shape[:-1])
    for seed_code in (None, seed):
        want = ref_minima.tile_state_chain_codes(
            jax, jnp, jnp.asarray(tl), jnp.asarray(is_start),
            None if seed_code is None else jnp.asarray(seed_code), True)
        got = minima.tile_state_chain_codes(
            torch.from_numpy(tl), torch.from_numpy(is_start),
            None if seed_code is None else torch.from_numpy(seed_code), True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _permuting(monkeypatch):
    """Every selection entry point returns its columns in a random order."""
    gen = torch.Generator().manual_seed(0)
    for name in ENTRIES:
        fn = getattr(minima, name)

        def permuted(*a, _fn=fn, **kw):
            cols = _fn(*a, **kw)
            return cols[:, torch.randperm(cols.shape[1], generator=gen)]

        monkeypatch.setattr(minima, name, permuted)


@pytest.mark.parametrize("caller", ["single", "batched", "sharded"])
@pytest.mark.parametrize("alpha,m,k", [(None, 23, 3), (0.5, 24, 3),
                                       (0.1, 110, 10)])
def test_callers_do_not_depend_on_selection_order(caller, alpha, m, k,
                                                  monkeypatch):
    """``TorchEngine.candidates``, ``BatchEngine.candidates_many`` and
    ``ShardedSearch.candidates_batch`` give the same results when the
    selections return their candidates permuted: the word level, the
    word level with the overshoot strip, and the position level."""
    monkeypatch.setattr(plan, "H100_TARGET_TILES", 8)
    prof = profiles.Iupac()
    rng = np.random.default_rng(m + k)
    pats = [rng.choice(BASES, m) for _ in range(3)]
    texts = [_planted(i, 900, pats[i % 3], copies=3, sub=1)
             for i in range(4)]
    for t, p in zip(texts, pats):
        t[-(m - 4):] = p[: m - 4]
    codes = [prof.encode(p) for p in pats]

    def run():
        if caller == "single":
            eng = TorchEngine("cpu")
            return [eng.candidates(prof, c, t, k, alpha, None, False)
                    for c in codes for t in texts]
        if caller == "batched":
            return BatchEngine("cpu").candidates_many(prof, codes, texts, k,
                                                      alpha)
        ss = ShardedSearch(mesh=make_mesh(2, 2, device="cpu"))
        return ss.candidates_batch(prof, pats, np.concatenate(texts), k,
                                   alpha=alpha)

    want = run()
    assert any(len(x) for row in want for x in row)
    _permuting(monkeypatch)
    assert run() == want


def test_selection_sources_are_built_and_hashed(monkeypatch, tmp_path):
    """Both kernel sources and their shared header go to the one nvcc
    call, and the library's name changes with each of their bytes."""
    names = {f.name for f in myers_cuda.SOURCES}
    assert {"select_words.cu", "select_positions.cu"} <= names
    assert "select_common.cuh" in {f.name for f in myers_cuda.HEADERS}
    assert str(len(myers_cuda.SOURCES)) in myers_cuda.NVCC_FLAGS
    seen = {myers_cuda.library_path()}
    for which, name in (("SOURCES", "select_words.cu"),
                        ("SOURCES", "select_positions.cu"),
                        ("HEADERS", "select_common.cuh")):
        files = list(getattr(myers_cuda, which))
        i = [f.name for f in files].index(name)
        copy = tmp_path / f"{len(seen)}_{name}"
        copy.write_bytes(files[i].read_bytes() + b"\n// changed\n")
        files[i] = copy
        monkeypatch.setattr(myers_cuda, which, tuple(files))
        seen.add(myers_cuda.library_path())
    assert len(seen) == 4


def test_kernel_library_is_built_and_loaded_once(monkeypatch):
    """The wrappers' ``_lib()`` builds (or finds) and loads the library
    once per process, whatever the number of launches; ``cache_clear``
    starts over."""
    calls = []
    monkeypatch.setattr(myers_cuda, "build",
                        lambda: calls.append("build") or "lib.so")
    monkeypatch.setattr(myers_cuda, "load_library",
                        lambda path: calls.append(path) or object())
    myers_cuda._lib.cache_clear()
    try:
        first = myers_cuda._lib()
        assert myers_cuda._lib() is first and myers_cuda._lib() is first
        assert calls == ["build", "lib.so"]
        myers_cuda._lib.cache_clear()
        assert myers_cuda._lib() is not first
        assert calls == ["build", "lib.so"] * 2
    finally:
        myers_cuda._lib.cache_clear()


def _bound_bytes_by_enumeration(entry, args, n_out):
    """The bytes a selection call must move, counted position by position
    and word by word: what ``diagnostics.select_bound`` computes."""
    if entry == "select_words_tiles_q":
        (_, _, _, meta, vf, _, _, _, _, _, all_minima, tend, _,
         n_prev) = args
        scr = ((meta & 1) != 0).numpy()
        strip, tiles, pairs = set(), set(), set()
        for q, w, t in zip(*np.nonzero(scr)):
            tiles.add(t)
            pairs.add((q, t))
            for ww in range(max(0, w - n_prev), w):
                if not scr[q, ww, t] and 32 * ww + 32 > int(vf[t]):
                    strip.add((q, ww, t))
        state = not all_minima
        return (4 * meta.numel() + 12 * int(scr.sum())
                + 8 * len(strip) * state
                + len(tiles) * (20 + 8 * (tend is not None))
                + 4 * len(pairs) * state + 32 * n_out)
    if entry == "select_candidates":
        vp, W, max_pos = args[0], args[3], args[7]
        all_minima = args[10]
        min_pos, owned_end, state0 = (list(args[11:]) + [None] * 3)[:3]
        p = np.arange(1, vp.shape[1] * W * 32 + 1)
        need = p <= min(max_pos, owned_end or max_pos)
        if state0 is not None or all_minima:
            need &= p >= (min_pos or 0)
        words = np.unique((p[need] - 1) // 32)
        return 8 * len(words) + 4 * len(np.unique(words // W)) + 16 * n_out
    vp, vf, vt, alpha, all_minima = (args[0], args[5], args[6], args[10],
                                     args[12])
    Q, NW, T = vp.shape
    total = 0
    for t in range(T):
        p = np.arange(1, NW * 32 + 1)
        words = len(np.unique((p[(p > int(vf[t])) & (p <= int(vt[t]))] - 1)
                              // 32))
        own0 = int(vf[t]) < 0 <= int(vt[t])
        live = words > 0 or own0
        total += (Q * (8 * words + 4 * (words > 0) + 4 * own0
                       + 4 * live * (not all_minima))
                  + live * (20 + 8 * (alpha != 0)))
    return total + 32 * n_out


@pytest.mark.parametrize("entry,case", [
    ("select_words_tiles_q", False), ("select_words_tiles_q", True),
    ("select_candidates", None), ("select_candidates", (700, 2900, 1)),
    ("select_candidates", (700, 2900, None)),
    ("select_candidates_tiles", False), ("select_candidates_tiles", True)])
def test_select_bound_counts_what_the_selection_must_read(entry, case):
    """The selections' bound (the kernels line's bound_ms) counts only the
    words, tables and seeds a call must read: screened words and their
    strips, owned positions' vp and vm with one cost a tile, the tables of
    tiles in use; held to a count by enumeration."""
    if entry == "select_words_tiles_q":
        args = _word_args()
        args = args[:10] + (case,) + args[11:]
    elif entry == "select_candidates":
        args = _position_args()[2]
        if case is not None:
            args += case
    else:
        args = _tile_args()
        args = args[:12] + (case,)
    n_out = getattr(minima, entry)(*args).shape[1]
    got = diagnostics.select_bound(entry, args, {}, n_out)
    assert got["bytes"] == _bound_bytes_by_enumeration(entry, args, n_out)
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(
        got["bytes"] / diagnostics.MEM_BYTES_PER_S * 1e3)


def test_minima_imports_without_cuda():
    """``ops/minima.py`` imports, and selects on the CPU, in a process
    that sees no CUDA device."""
    code = (
        "import torch\n"
        "from sassy_tpu_torch.ops import minima\n"
        "assert not torch.cuda.is_available()\n"
        "z = torch.zeros((1, 2, 3), dtype=torch.int32)\n"
        "t = torch.zeros(3, dtype=torch.int32)\n"
        "got = minima.select_words_tiles_q(z, z, z + 9, z + 1, t - 1, t + 64,"
        " t - 1, torch.zeros(3, dtype=torch.int64), 1, t[None], False)\n"
        "assert got.shape == (4, 0), got\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                 PYTHONPATH=str(myers_cuda.CSRC.parents[1])))
    assert proc.returncode == 0, proc.stderr
