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
from sassy_tpu_torch.ops.myers_torch import TorchEngine, Windows
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
        Windows.of(a[0]), t(tile0), t(vf), t(vt), *a[4:9], k, "iupac")
    state0 = t(rng.integers(0, 2, (Q, T)).astype(np.int32))
    pos_base = t(np.arange(T, dtype=np.int64) * (NW * 32 + 1))
    return (vp, vm, cost, meta, t(vf), t(vt), t(islast), pos_base, k,
            state0, False, t(tend.astype(np.int64)) if overhang else None,
            0.3 if overhang else None, 2 if overhang else 0)


def _chained_word_args():
    """``_word_args``' outputs with their final codes, piece starts and a
    carry: select_words_chained's arguments."""
    (vp, vm, cost, meta, vf, vt, islast, pos_base, k, _, all_minima, tend,
     alpha, n_prev) = _word_args()
    Q, _, T = vp.shape
    final = minima.meta_from_words(vp, vm, cost, vf, vt, k)[1]
    is_start = vf < 0
    carry = torch.tensor([[3], [0], [2]], dtype=torch.int32)[:Q]
    return (vp, vm, cost, meta, final, is_start, carry, vf, vt, islast,
            pos_base, k, all_minima, tend, alpha, n_prev)


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
    args = (Windows.of(args[0]), torch.from_numpy(tile0), *args[2:])
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
            myers_cuda.select_words_chained.launches,
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
    """Every selection entry point returns its columns in a random order
    (the chained ones beside their carry)."""
    gen = torch.Generator().manual_seed(0)
    for name in (*ENTRIES, "select_candidates_chained",
                 "select_words_chained"):
        fn = getattr(minima, name)

        def permuted(*a, _fn=fn, **kw):
            got = _fn(*a, **kw)
            cols = got[0] if isinstance(got, tuple) else got
            cols = cols[:, torch.randperm(cols.shape[1], generator=gen)]
            return (cols, got[1]) if isinstance(got, tuple) else cols

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
    """Both kernel sources, their shared header, the position level's
    walk and the word level's grid and chain go to the one nvcc call, and
    the library's name changes with each of their bytes."""
    names = {f.name for f in myers_cuda.SOURCES}
    assert {"select_words.cu", "select_positions.cu"} <= names
    assert {"select_common.cuh", "select_walk.cuh", "select_words.cuh"} <= {
        f.name for f in myers_cuda.HEADERS}
    assert str(len(myers_cuda.SOURCES)) in myers_cuda.NVCC_FLAGS
    seen = {myers_cuda.library_path()}
    for which, name in (("SOURCES", "select_words.cu"),
                        ("SOURCES", "select_positions.cu"),
                        ("HEADERS", "select_common.cuh"),
                        ("HEADERS", "select_walk.cuh"),
                        ("HEADERS", "select_words.cuh")):
        files = list(getattr(myers_cuda, which))
        i = [f.name for f in files].index(name)
        copy = tmp_path / f"{len(seen)}_{name}"
        copy.write_bytes(files[i].read_bytes() + b"\n// changed\n")
        files[i] = copy
        monkeypatch.setattr(myers_cuda, which, tuple(files))
        seen.add(myers_cuda.library_path())
    assert len(seen) == 6


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
    if entry in ("select_words_tiles_q", "select_words_chained"):
        if entry == "select_words_chained":
            final = args[4]
            args = args[:4] + args[7:12] + (None,) + args[12:]
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
        if entry == "select_words_chained":
            Q, T = final.shape
            seeds = (4 * Q * T + T) * state + 8 * Q
        else:
            seeds = 4 * len(pairs) * state
        return (4 * meta.numel() + 12 * int(scr.sum())
                + 8 * len(strip) * state
                + len(tiles) * (20 + 8 * (tend is not None))
                + seeds + 32 * n_out)
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
    chained = entry == "select_candidates_chained"
    vp, vf, vt, alpha, all_minima = (args[0], args[5], args[6], args[10],
                                     args[13 if chained else 12])
    Q, NW, T = vp.shape
    total = 8 * Q if chained else 0
    for t in range(T):
        p = np.arange(1, NW * 32 + 1)
        words = len(np.unique((p[(p > int(vf[t])) & (p <= int(vt[t]))] - 1)
                              // 32))
        own0 = int(vf[t]) < 0 <= int(vt[t])
        live = words > 0 or own0
        seeds = (1 if chained else 4 * Q) * live * (not all_minima)
        total += (Q * (8 * words + 4 * (words > 0) + 4 * own0) + seeds
                  + live * (20 + 8 * (alpha != 0)))
    return total + 32 * n_out


@pytest.mark.parametrize("entry,case", [
    ("select_words_tiles_q", False), ("select_words_tiles_q", True),
    ("select_words_chained", False), ("select_words_chained", True),
    ("select_candidates", None), ("select_candidates", (700, 2900, 1)),
    ("select_candidates", (700, 2900, None)),
    ("select_candidates_tiles", False), ("select_candidates_tiles", True),
    ("select_candidates_chained", False),
    ("select_candidates_chained", True)])
def test_select_bound_counts_what_the_selection_must_read(entry, case):
    """The selections' bound (the kernels line's bound_ms) counts only the
    words, tables and seeds a call must read: screened words and their
    strips, owned positions' vp and vm with one cost a tile, the tables of
    tiles in use; held to a count by enumeration."""
    if entry == "select_words_tiles_q":
        args = _word_args()
        args = args[:10] + (case,) + args[11:]
    elif entry == "select_words_chained":
        args = _chained_word_args()
        args = args[:12] + (case,) + args[13:]
    elif entry == "select_candidates":
        args = _position_args()[2]
        if case is not None:
            args += case
    elif entry == "select_candidates_tiles":
        args = _tile_args()
        args = args[:12] + (case,)
    else:
        args = _chain_args() + (torch.zeros((3, 1), dtype=torch.int32),
                                case)
    got = getattr(minima, entry)(*args)
    n_out = (got[0] if isinstance(got, tuple) else got).shape[1]
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


# ---------------------------------------------------------------------------
# the position-level kernels' walk (csrc/select_walk.cuh) on the host: a g++
# build of the header, its tile records composed in tile order, against the
# plain versions

REC = np.dtype([("n", "<i4", 2), ("bits", "<u8")])  # select_walk.cuh TileRec
MAP_SHIFT = 48


def _walk_host():
    """The host program over select_walk.cuh, built with g++ (no fused
    float products, as the card rounds them) into build/sassy_tpu_torch/."""
    import ctypes

    from sassy_tpu_torch import gxx

    here = os.path.dirname(os.path.abspath(__file__))
    csrc = myers_cuda.CSRC
    lib = ctypes.CDLL(str(gxx.build(
        "select_walk_host",
        [os.path.join(here, "torch_select_walk_host.cc"),
         csrc / "select_walk.cuh", csrc / "select_common.cuh"],
        ["-std=c++17", "-O1", "-shared", "-fPIC", "-ffp-contract=off",
         f"-I{csrc}"])))
    ptr, num, big = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sassy_walk_text.argtypes = ([ptr] * 3 + [big] * 6 + [num] * 7
                                    + [ctypes.c_float, num] + [ptr] * 4
                                    + [big])
    lib.sassy_walk_pieces.argtypes = ([ptr] * 12 + [big] * 2 + [num] * 5
                                      + [ctypes.c_float, num] + [ptr] * 4
                                      + [big])
    return lib


def _np_ptr(a):
    return None if a is None else a.ctypes.data


def _compose(recs):
    """The records composed in item order from state 0 (the first item's
    state is forced or unused): each item's entering state and output
    offset, the state each leaves, and the total."""
    enter = np.zeros(len(recs), np.int32)
    offsets = np.zeros(len(recs), np.int64)
    leaving = np.zeros(len(recs), np.int32)
    s, off = 0, 0
    for i, r in enumerate(recs):
        enter[i], offsets[i] = s, off
        off += int(r["n"][s])
        s = (int(r["bits"]) >> (MAP_SHIFT + s)) & 1
        leaving[i] = s
    return enter, offsets, leaving, off


def _walk(fn, args, n_items, rows):
    """Both passes of the host program: the records, their composition,
    then the (rows, N) columns."""
    recs = np.zeros(n_items, REC)
    fn(*args, 0, recs.ctypes.data, None, None, None, 0)
    enter, offsets, leaving, N = _compose(recs)
    out = np.zeros((rows, N), np.int64)
    fn(*args, 1, recs.ctypes.data, enter.ctypes.data, offsets.ctypes.data,
       _np_ptr(out), N)
    return recs, enter, leaving, out


def _words(x):
    return np.ascontiguousarray(x.numpy())


def _text_states(vp, vm, W, halo, n_text, alpha, gate, seed):
    """The state entering each tile of one text (1 up), from every flat
    position's delta with its overshoot step, as select_candidates_plain's
    running state sees them."""
    T = vp.shape[1]
    own = lambda x: np.concatenate(  # noqa: E731
        [x[:W, 0]] + [x[halo : halo + W, t] for t in range(1, T)]).view(
            np.uint32)
    bit = np.arange(32, dtype=np.uint32)
    d = (((own(vp)[:, None] >> bit) & 1).astype(np.int64)
         - ((own(vm)[:, None] >> bit) & 1)).reshape(-1)
    p = np.arange(1, d.size + 1)
    a32 = np.float32(alpha or 0.0)
    ov = lambda x: np.floor(  # noqa: E731
        a32 * np.maximum(x - n_text, 0).astype(np.float32)).astype(np.int64)
    d = d + ov(p) - ov(p - 1)
    feed = (d != 0) & (p >= gate)
    states = []
    for t in range(T):
        hit = np.nonzero(feed[: t * W * 32])[0]
        states.append(int(d[hit[-1]] > 0) if hit.size else seed)
    return np.array(states)


def _long_text_args(k, n=12_000):
    """A position-level single search's q1 outputs over 12 tiles of 32
    words (120 bp, alpha 0.1, copies hanging off both ends, n chars: at
    11,200 the overshoot steps cross into the last tile):
    select_candidates' arguments up to k."""
    monkey = plan.H100_TARGET_TILES
    plan.H100_TARGET_TILES = 1 << 20
    try:
        prof = profiles.Iupac()
        pat = np.random.default_rng(2).choice(BASES, 120)
        text = _planted(4, n, pat, copies=10, sub=4)
        eng = TorchEngine("cpu")
        inp = eng.build_inputs(prof, prof.encode(pat), text, k, 0.1, None,
                               False)
        vp, vm, cost = eng.scan(inp)
    finally:
        plan.H100_TARGET_TILES = monkey
    assert not inp.fast and vp.shape[1] == 12
    return (vp, vm, cost, inp.W, inp.halo, inp.boundary_m, inp.n_text,
            inp.max_pos, k)


TEXT_CASES = [(10, 0.1, False, None), (10, 0.1, True, None),
              (60, 0.1, False, None), (60, 0.1, True, None),
              (60, 0.0, False, None), (10, 0.1, False, (3000, 9000, 1)),
              (60, 0.1, False, (3000, 9000, 0)),
              (60, 0.1, False, (3000, 9000, 1)),
              (60, 0.1, True, (3000, 9000, 1)),
              (60, 0.1, False, (11_900, None, 1)),
              (60, 0.1, False, (0, None, 0)), (-1, 0.1, False, None),
              (10, 0.1, False, None, 11_200), (40, 0.3, False, None, 11_200),
              (60, 0.1, True, (3000, None, 1), 11_200)]


@pytest.mark.parametrize("k,alpha,all_minima,owned,n",
                         [c + (12_000,) if len(c) == 4 else c
                          for c in TEXT_CASES])
def test_walk_host_text_equals_plain(k, alpha, all_minima, owned, n):
    """select_walk.cuh's walk of one text's tiles, built for the host: the
    records composed in tile order give each tile the entering state of
    the plain version's running state and the count of its candidates,
    and the writing walk over the flagged word groups gives
    ``select_candidates_plain``'s columns in the same order (12 tiles of
    a position-level single search with copies hanging off both ends, at
    k = 10 and, dense, 60; the sharded owned range and incoming state;
    all_minima; no overshoot; overshoot steps that cross into the last
    tile; no candidate)."""
    vp, vm, cost, W, halo, bm, n_text, max_pos, _ = _long_text_args(10, n)
    min_pos, owned_end, state0 = owned or (None, None, None)
    want = minima.select_candidates_plain(
        vp, vm, cost, W, halo, bm, n_text, max_pos, k, alpha, all_minima,
        min_pos, owned_end, state0).numpy()
    assert want.shape[1] or k < 0
    T = vp.shape[1]
    vpn, vmn, cn = _words(vp), _words(vm), _words(cost)
    lib = _walk_host()
    call = (vpn.ctypes.data, vmn.ctypes.data, cn.ctypes.data, T, bm, n_text,
            max_pos, min_pos or 0,
            myers_cuda.NO_END if owned_end is None else owned_end, T, W,
            halo, k, int(all_minima), int(state0 is not None),
            int(bool(state0)), alpha)
    recs, enter, _, got = _walk(lib.sassy_walk_text, call, T, 2)
    np.testing.assert_array_equal(got, want)
    tile = np.maximum(want[0] - 1, 0) // (W * 32)
    n_want = np.bincount(tile, minlength=T)
    states = np.array(enter)
    if not all_minima:
        states[0] = bool(state0)
        gate = min_pos if state0 is not None else 0
        np.testing.assert_array_equal(
            states, _text_states(vp, vm, W, halo, n_text, alpha, gate,
                                 int(bool(state0))))
    np.testing.assert_array_equal(recs["n"][np.arange(T), states], n_want)
    # the flagged groups: every group holding a candidate, for some state
    G = -(-W // 16)
    group = np.maximum(want[0] - 1, 0) % (W * 32) // 32 // G
    flags = recs["bits"][tile] >> group.astype(np.uint64) & np.uint64(1)
    assert flags.all()


def _chain_args(Q=3, T=60, NW=4, k=6, alpha=0.1, seed=3, starts=0.1,
                early_end=False):
    """Random q2 outputs over pieces, a few of which start a text (with
    ``early_end``, whose text ends a word past valid_from, the rest of the
    piece overshoot): select_candidates_chained's arguments but the
    carry."""
    rng = np.random.default_rng(seed)
    tile0, vf, vt, tend, islast = _piece_tables(rng, T, NW, True)
    if early_end:
        tend = np.maximum(vf, 0) + 32
    tile0 = rng.random(T) < starts
    vf = np.where(tile0, -1, np.maximum(vf, 0)).astype(np.int32)
    args = _q2_args("iupac", Q, M=24, T=T, NW=NW, seed=seed + 7)
    args = (Windows.of(args[0]), torch.from_numpy(tile0), *args[2:])
    vp, vm, cost = myers_cuda.scan_q_plain(*args)
    boundary0 = torch.where(torch.from_numpy(tile0)[None], args[6][:, None],
                            args[5][:, None])
    t = torch.from_numpy
    pos_base = t((5 << 30) + np.arange(T, dtype=np.int64) * (NW * 32 + 1))
    return (vp, vm, cost, boundary0, t(tend.astype(np.int64)), t(vf), t(vt),
            t(islast), pos_base, k, alpha, t(tile0))


def _sparse_chain_args(Q=3, T=80, NW=12, k=8, alpha=0.1, seed=5):
    """Pieces of sparse deltas (cost plateaus) whose texts end a word past
    valid_from: vp and vm with a bit in eight, each word's start cost the
    one before plus popc(vp) - popc(vm) (as a scan gives them), from near
    k; select_candidates_chained's arguments but the carry."""
    rng = np.random.default_rng(seed)
    tile0, vf, vt, _, islast = _piece_tables(rng, T, NW, True)
    tend = (np.maximum(vf, 0) + 32).astype(np.int64)

    def bits():
        return rng.integers(0, 2**32, (Q, NW, T), dtype=np.uint64).astype(
            np.uint32)
    vp = bits() & bits() & bits()
    vm = bits() & bits() & bits() & ~vp
    pc = lambda x: np.unpackbits(  # noqa: E731
        x.view(np.uint8).reshape(*x.shape, 4), axis=-1).sum(-1)
    step = pc(vp).astype(np.int64) - pc(vm)
    start = rng.integers(k - 4, k + 12, (Q, 1, T))
    cost = start + np.concatenate(
        [np.zeros_like(step[:, :1]), np.cumsum(step, 1)[:, :-1]], 1)
    t = torch.from_numpy
    w = lambda a: t(np.ascontiguousarray(a).view(np.int32))  # noqa: E731
    cost = t(cost.astype(np.int32))
    pos_base = t(np.arange(T, dtype=np.int64) * (NW * 32 + 1))
    return (w(vp), w(vm), cost, cost[:, 0].clone(), t(tend), t(vf), t(vt),
            t(islast), pos_base, k, alpha, t(tile0))


PIECE_CASES = [("chained", 6, 0.1, False, 0), ("chained", 6, 0.1, False, 3),
               ("sparse", 8, 0.1, False, 3), ("sparse", 8, 0.3, False, 0),
               ("sparse", 12, 0.02, True, 3),
               ("early_end", 10, 0.02, False, 3),
               ("early_end", 14, 0.05, False, 0),
               ("chained", 6, 0.1, True, 3), ("chained", 12, 0.5, False, 3),
               ("chained", 6, 0.0, False, 0), ("chained", -1, 0.1, False, 3),
               ("state0", 6, 0.1, False, None),
               ("state0", 12, 0.5, True, None),
               ("state0", 6, 0.0, False, None)]


@pytest.mark.parametrize("mode,k,alpha,all_minima,carry", PIECE_CASES)
def test_walk_host_pieces_equal_plain(mode, k, alpha, all_minima, carry):
    """select_walk.cuh's walk of Q patterns' pieces, built for the host:
    chained (resets at the pieces that start a text, the carry entering
    each pattern's first piece, one run of Q x T items across the
    patterns) the composed records give every piece the plain chain's
    state and candidate count, every pattern's carry out, and the
    columns of ``select_candidates_chained_plain`` in the same order, also
    where most of each piece lies past its text end (words skipped whole
    there, their state read from their overshoot steps); with a state per
    piece, those of ``select_candidates_tiles_plain``."""
    if mode == "sparse":
        (vp, vm, cost, b0, tend, vf, vt, il, pb, _, _,
         is_start) = _sparse_chain_args(k=k, alpha=alpha)
    else:
        (vp, vm, cost, b0, tend, vf, vt, il, pb, _, _,
         is_start) = _chain_args(k=k, alpha=alpha,
                                 NW=12 if mode == "early_end" else 4,
                                 early_end=mode == "early_end")
    Q, NW, T = vp.shape
    rng = np.random.default_rng(k + 100)
    state0 = carry_in = None
    if mode != "state0":
        carry_in = torch.full((Q, 1), carry, dtype=torch.int32)
        carry_in[1] = 3 - carry  # the patterns carry in different states
        want, want_carry = minima.select_candidates_chained_plain(
            vp, vm, cost, b0, tend, vf, vt, il, pb, k, alpha, is_start,
            carry_in, all_minima)
        codes = minima.last_delta_codes(vp, vm, vf, vt)
        edge = torch.zeros(1, dtype=torch.bool)
        chain = minima.tile_state_chain_codes(
            torch.cat([carry_in, codes, torch.zeros_like(carry_in)], 1),
            torch.cat([edge, is_start, edge]))[:, 1:-1].numpy()
    else:
        state0 = torch.from_numpy(rng.integers(0, 2, (Q, T)).astype(np.int32))
        want = minima.select_candidates_tiles_plain(
            vp, vm, cost, b0, tend, vf, vt, il, pb, k, alpha, state0,
            all_minima)
        chain = state0.numpy()
    want = want.numpy()
    assert want.shape[1] or k < 0
    keep = [_words(x) for x in (vp, vm, cost, b0, tend, vf, vt, il, pb)]
    starts = (None if mode == "state0"
              else np.ascontiguousarray(is_start.numpy().astype(np.uint8)))
    s0 = None if state0 is None else _words(state0)
    cin = None if carry_in is None else _words(carry_in)
    call = ([x.ctypes.data for x in keep]
            + [_np_ptr(s0), _np_ptr(starts), _np_ptr(cin), NW * T, T, Q, NW,
               T, k, int(all_minima), alpha])
    recs, enter, leaving, got = _walk(_walk_host().sassy_walk_pieces, call,
                                      Q * T, 4)
    np.testing.assert_array_equal(got, want)
    # each piece's state: the chain's, forced where the piece resets or
    # starts a pattern
    forced = np.ones((Q, T), bool) if mode == "state0" else (
        np.tile(is_start.numpy(), (Q, 1)))
    if mode != "state0":
        forced[:, 0] = True
    states = np.where(forced.reshape(-1), chain.reshape(-1), enter)
    if not all_minima:
        np.testing.assert_array_equal(states, chain.reshape(-1))
    n_want = np.bincount(want[0] * T + want[1], minlength=Q * T)
    np.testing.assert_array_equal(recs["n"][np.arange(Q * T), states],
                                  n_want)
    if mode != "state0" and not all_minima:
        got_carry = np.where(leaving.reshape(Q, T)[:, -1] == 1, 3, 0)
        np.testing.assert_array_equal(got_carry, want_carry.numpy()[:, 0])


@pytest.mark.parametrize("carry", [0, 3])
def test_chained_cpu_tensors_run_the_plain_version(carry):
    """On CPU tensors the chained entry point calls its plain version once
    and returns its columns and carry; no kernel counter moves. The plain
    version is select_candidates_tiles_plain over the states of
    last_delta_codes chained by tile_state_chain_codes, the carry a
    virtual piece before the first."""
    args = _chain_args()
    Q, T = args[0].shape[0], args[0].shape[2]
    carry_in = torch.full((Q, 1), carry, dtype=torch.int32)
    kernels = _kernel_counts()
    calls = minima.select_candidates_chained_plain.calls
    cols, carry_out = minima.select_candidates_chained(*args, carry_in,
                                                       False)
    assert minima.select_candidates_chained_plain.calls == calls + 1
    assert _kernel_counts() == kernels
    codes = minima.last_delta_codes(args[0], args[1], args[5], args[6])
    edge = torch.zeros(1, dtype=torch.bool)
    st = minima.tile_state_chain_codes(
        torch.cat([carry_in, codes, torch.zeros_like(carry_in)], 1),
        torch.cat([edge, args[11], edge]))
    want = minima.select_candidates_tiles_plain(*args[:11], st[:, 1:-1],
                                                False)
    assert cols.shape[1] and torch.equal(cols, want)
    assert torch.equal(carry_out, torch.where(st[:, -1:] == 1, 3, 0).to(
        torch.int32))
    assert carry_out.shape == (Q, 1) and T == args[11].shape[0]


def test_chained_other_devices_raise():
    """Tensors on neither the CPU nor a CUDA device go to the kernel
    wrapper, which refuses them before any build or launch."""
    args = _chain_args() + (torch.zeros((3, 1), dtype=torch.int32), False)
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    with pytest.raises(ValueError, match="cpu or cuda"):
        minima.select_candidates_chained(*meta)
