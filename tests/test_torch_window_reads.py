"""The scan kernels' window read, on the CPU.

On the card the four search-path scan kernels (q1meta, q2meta, q1, q2)
read each tile's window straight from the packed planes through a
descriptor, ``myers_torch.Windows``: window word i of tile t, plane p, is
``planes[p, wstart[t] + i]`` where ``0 <= wstart[t] + i < min(wend[t],
L)``, else 0. Here:

- ``windows_plain`` (the plain read) on the single engine's descriptors
  equals the JAX package's window build (``_scan_words(...,
  "return_windows")``, with the overhang tail tile injected as its
  pipeline does) for the five shapes of ``test_windows_equal_reference``,
  a tail tile, 'N' overlay steps and halo > W;
- on the batched engine's piece descriptors it equals the JAX package's
  host packing, ``_pack_pieces_np``, for both strands, with and without
  overshoot, with an empty text;
- each of the four plain entry points on a descriptor equals the same
  function on the windows it gathers, and ``Windows.of`` describes a
  window tensor's own words;
- a g++ build of the read itself (``csrc/window_read.cuh`` through
  ``tests/torch_window_read_host.cc``) runs the kernels' register ring at
  every start alignment, with wend inside a 16-byte group, before the
  planes and past them, and equals ``windows_plain`` without loading a
  word outside the planes.
"""

import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sassy_tpu import profiles as ref_profiles
from sassy_tpu.ops import batch as ref_batch
from sassy_tpu.ops import myers_xla
from sassy_tpu_torch import profiles
from sassy_tpu_torch.ops import batch, myers_cuda, myers_torch, plan
from sassy_tpu_torch.ops.myers_torch import (
    TorchEngine,
    Windows,
    tile_windows,
    windows_plain,
)
from test_torch_cuda import _random_inputs, _random_q_inputs

BASES = np.frombuffer(b"ACGT", np.uint8)


def _ref_windows(planes, T, W, halo) -> np.ndarray:
    """The JAX package's (NW, P, T) window build over uint32 planes."""
    dummy = jnp.zeros((1,), jnp.uint32)
    got = myers_xla._kernels()["scan_words"](
        jnp.asarray(planes), jnp.zeros((1, planes.shape[0]), jnp.uint32),
        dummy, dummy, 1, 1, "iupac", T, W, halo, "return_windows", False)
    return np.asarray(got).view(np.int32)


def _gathered(win: Windows) -> np.ndarray:
    return windows_plain(win.planes, win.wstart, win.wend, win.NW).numpy()


# ---------------------------------------------------------------------------
# the plain read on the single engine's descriptors


@pytest.mark.parametrize("gw,T,W,halo", [
    (80, 4, 16, 1),
    (80, 5, 10, 12),  # halo > W: two halo strips
    (100, 3, 40, 2),  # T*W > gw: padded tail
    (100, 1, 200, 0),  # one tile longer than the planes
    (300, 7, 33, 5),
])
def test_tile_descriptors_equal_reference(gw, T, W, halo):
    rng = np.random.default_rng(gw + T + W + halo)
    planes = rng.integers(0, 2**32, (4, gw), dtype=np.uint64).astype(np.uint32)
    win = tile_windows(torch.from_numpy(planes.view(np.int32)), T, W, halo)
    assert win.shape == (W + halo + 1, 4, T)
    np.testing.assert_array_equal(_gathered(win),
                                  _ref_windows(planes, T, W, halo))


def _engine_inputs(m, k, alpha, n, seed, target_tiles, monkeypatch):
    """The single engine's inputs for a random pattern over random IUPAC
    text; ``target_tiles`` None plans tiles of W = 3 words (the planner
    keeps W >= 4 halos: any halo reads the same text)."""
    if target_tiles is None:
        monkeypatch.setattr(myers_torch, "plan_tiles",
                            lambda words, halo: (-(-words // 3), 3, halo))
    else:
        monkeypatch.setattr(plan, "H100_TARGET_TILES", target_tiles)
    rng = np.random.default_rng(seed)
    prof = profiles.Iupac()
    text = rng.choice(np.frombuffer(b"ACGTNRY", np.uint8), n)
    pat = rng.choice(BASES, m)
    inp = TorchEngine("cpu").build_inputs(prof, prof.encode(pat), text, k,
                                          alpha)
    return text, inp


@pytest.mark.parametrize("m,k,alpha,n,target", [
    (23, 3, 0.5, 3001, 16),  # word level: the overhang tail tile
    (40, 4, 0.5, 96, 4),  # the tail tile from the text start
    (120, 10, 0.1, 2999, 8),  # position level: overlay, no tail tile
    (120, 10, None, 3000, None),  # halo > W
    (120, 10, 0.5, 2500, None),  # halo > W and the tail tile
])
def test_engine_descriptors_equal_reference(m, k, alpha, n, target,
                                            monkeypatch):
    """The descriptors ``TorchEngine.build_inputs`` hands the kernels,
    gathered, equal the JAX pipeline's windows over the same planes (the
    'N' overlay of ``planes_for``), its tail tile injected as
    ``myers_xla`` does; the tiles' offsets are 32 wstart."""
    text, inp = _engine_inputs(m, k, alpha, n, m + n, target, monkeypatch)
    win = inp.windows
    NW, P, T = win.shape
    steps = inp.max_pos - inp.n_text
    ref_prep = myers_xla.PreparedText(ref_profiles.Iupac(), text)
    planes = np.asarray(ref_prep.planes_for(steps))
    want = _ref_windows(planes, T, inp.W, inp.halo).copy()
    if inp.n_prev:  # the tail tile: NW words from ws0, zeros past the planes
        rescan = max(inp.halo * 32, inp.pmasks.shape[0] + k)
        ws0 = min(max((inp.n_text - rescan) // 32, 0), planes.shape[1])
        pad = np.concatenate([planes, np.zeros((P, NW), np.uint32)], 1)
        want[:, :, T - 1] = pad[:, ws0 : ws0 + NW].T.view(np.int32)
        assert int(win.wstart[-1]) == ws0
    if target is None:
        assert inp.halo > inp.W
    np.testing.assert_array_equal(win.planes.numpy(), planes.view(np.int32))
    np.testing.assert_array_equal(_gathered(win), want)
    assert torch.equal(inp.offset, win.wstart * 32)


def test_gather_tiles_takes_descriptors(monkeypatch):
    """The suffix prefilter's gather keeps two numbers a tile: the windows
    of the tiles kept, their offsets with them."""
    _, inp = _engine_inputs(80, 3, None, 4000, 9, 16, monkeypatch)
    ids = torch.tensor([0, 3, 4, inp.windows.shape[2] - 1])
    sub = TorchEngine.gather_tiles(inp, ids)
    assert sub.windows.planes is inp.windows.planes
    np.testing.assert_array_equal(_gathered(sub.windows),
                                  _gathered(inp.windows)[:, :, ids.numpy()])
    assert torch.equal(sub.offset, inp.offset[ids])


# ---------------------------------------------------------------------------
# the plain read on the batched engine's piece descriptors


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("steps", [0, 7, 101])
def test_piece_descriptors_equal_reference(steps, reverse):
    """``TextSet.descriptor``, gathered, equals ``_pack_pieces_np`` (an
    empty text and a one-char text among them); the planes' rows are a
    multiple of the kernels' alignment."""
    prof = profiles.Iupac()
    rng = np.random.default_rng(steps + reverse)
    texts = [rng.choice(np.frombuffer(b"ACGTNRY", np.uint8), int(n))
             for n in rng.integers(0, 900, 9)] + [np.zeros(0, np.uint8)]
    texts[2] = texts[2][:1]
    ts = batch.TextSet(texts, "cpu")
    halo, w_chars = 27, 256
    pp = ts.piece_plan(halo, w_chars, steps)
    pieces = ref_batch._plan_pieces(ts.lens, steps, w_chars, halo)
    want = ref_batch._pack_pieces_np(
        ref_profiles.Iupac(), ref_batch.TextSet(texts)._texts_for(reverse),
        pieces, w_chars, steps,
    ).transpose(2, 0, 1).view(np.int32)
    win = ts.descriptor(prof, pp, reverse, 0, pp.T)
    assert win.shape == want.shape
    assert win.planes.shape[1] % myers_torch.PLANE_ALIGN_WORDS == 0
    np.testing.assert_array_equal(_gathered(win), want)
    part = ts.descriptor(prof, pp, reverse, 3, 11)
    np.testing.assert_array_equal(_gathered(part), want[:, :, 3:11])


def test_piece_descriptors_of_an_empty_text():
    prof = profiles.Dna()
    ts = batch.TextSet([np.zeros(0, np.uint8)], "cpu")
    pp = ts.piece_plan(27, 256)
    want = ref_batch._pack_pieces_np(
        ref_profiles.Dna(), ref_batch.TextSet([np.zeros(0, np.uint8)])
        ._texts_for(False), ref_batch._plan_pieces([0], 0, 256, 27), 256, 0,
    ).transpose(2, 0, 1).view(np.int32)
    win = ts.descriptor(prof, pp, False, 0, pp.T)
    assert pp.T == 1 and int(win.wend[0]) == int(win.wstart[0])
    np.testing.assert_array_equal(_gathered(win), want)


# ---------------------------------------------------------------------------
# the plain entry points on descriptors


def _descriptor_of(win_np: np.ndarray, seed: int) -> Windows:
    """A descriptor whose windows are the (NW, P, T) words ``win_np``,
    each tile's words at an odd place in planes that hold other words
    around them."""
    NW, P, T = win_np.shape
    g = np.random.default_rng(seed)
    starts = np.cumsum(g.integers(NW + 1, NW + 9, T)) - NW
    L = -(-(int(starts[-1]) + NW + 5) // 4) * 4
    planes = g.integers(-2**31, 2**31, (P, L), dtype=np.int64).astype(np.int32)
    for t in range(T):
        planes[:, starts[t] : starts[t] + NW] = win_np[:, :, t].T
    wstart = torch.from_numpy(starts.astype(np.int64))
    return Windows(torch.from_numpy(planes), wstart, wstart + NW, NW)


@pytest.mark.parametrize("eq_mode", ["iupac", "pure", "ascii"])
def test_plain_entry_points_on_descriptors(eq_mode):
    """q1meta, q1, q2meta and q2's plain versions (and their wrappers on
    CPU tensors) on a descriptor equal the same function on the windows it
    gathers."""
    args = _random_inputs(eq_mode, 24, 37, 9, 5)
    win = _descriptor_of(args[0].numpy(), 1)
    assert torch.equal(win.gather(), args[0])
    own = Windows.of(args[0])  # the windows laid end to end
    for fn in (myers_cuda.scan_meta_plain, myers_cuda.scan_meta):
        for a, b in zip(fn(win, *args[1:]), fn(own, *args[1:])):
            assert torch.equal(a, b)
    one = (args[1], *args[4:9], eq_mode)
    for fn in (myers_cuda.scan_plain, myers_cuda.scan):
        for a, b in zip(fn(win, *one), fn(own, *one)):
            assert torch.equal(a, b)
    q_args = _random_q_inputs(eq_mode, 3, 24, 37, 9, 6)
    q_win = _descriptor_of(q_args[0].numpy(), 2)
    q_own = Windows.of(q_args[0])
    for fn in (myers_cuda.scan_q_meta_plain, myers_cuda.scan_q_meta):
        for a, b in zip(fn(q_win, *q_args[1:]), fn(q_own, *q_args[1:])):
            assert torch.equal(a, b)
    q_one = (q_args[1], *q_args[4:9], eq_mode)
    for fn in (myers_cuda.scan_q_plain, myers_cuda.scan_q):
        for a, b in zip(fn(q_win, *q_one), fn(q_own, *q_one)):
            assert torch.equal(a, b)
    with pytest.raises(TypeError, match="Windows"):
        myers_cuda.scan_meta_plain(*args)  # a window tensor is described


def test_windows_of_a_tensor():
    """``Windows.of`` lays a window tensor's tiles end to end in planes of
    aligned rows and describes them; gathered, they are the tensor."""
    g = np.random.default_rng(3)
    for NW, P, T in ((1, 4, 1), (7, 4, 5), (9, 9, 3), (4, 4, 2)):
        win = torch.from_numpy(g.integers(-2**31, 2**31, (NW, P, T),
                                          dtype=np.int64).astype(np.int32))
        d = Windows.of(win)
        assert d.shape == (NW, P, T)
        assert d.planes.shape[1] % myers_torch.PLANE_ALIGN_WORDS == 0
        assert torch.equal(d.gather(), win)
        assert torch.equal(d.take(torch.tensor([T - 1, 0])).gather(),
                           win[:, :, [T - 1, 0]])


def test_windows_plain_counts_its_calls():
    before = windows_plain.calls
    tile_windows(torch.zeros((4, 8), dtype=torch.int32), 2, 3, 1).gather()
    myers_torch.build_windows(torch.zeros((4, 8), dtype=torch.int32), 2, 3, 1)
    assert windows_plain.calls == before + 2


# ---------------------------------------------------------------------------
# the kernels' read, built with g++


def _host():
    """The host program over window_read.cuh, built with g++ into
    build/sassy_tpu_torch/."""
    from sassy_tpu_torch import gxx

    here = os.path.dirname(os.path.abspath(__file__))
    csrc = myers_cuda.CSRC
    lib = ctypes.CDLL(str(gxx.build(
        "window_read_host",
        [os.path.join(here, "torch_window_read_host.cc"),
         csrc / "window_read.cuh"],
        ["-std=c++17", "-O1", "-shared", "-fPIC", f"-I{csrc}"])))
    ptr, num, big = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sassy_window_read_host.argtypes = [ptr, big, num, ptr, ptr, num,
                                           num, ptr, ptr]
    lib.sassy_window_read_host.restype = num
    return lib


def _host_read(lib, win: Windows):
    """The host program's windows of ``win`` and its (loads, outside)."""
    NW, P, T = win.shape
    planes = np.ascontiguousarray(win.planes.numpy())
    ws = np.ascontiguousarray(win.wstart.numpy())
    we = np.ascontiguousarray(win.wend.numpy())
    out = np.full((NW, P, T), -7, np.int32)
    stats = np.zeros(2, np.int64)
    assert lib.sassy_window_read_host(
        planes.ctypes.data, planes.shape[1], P, ws.ctypes.data,
        we.ctypes.data, T, NW, out.ctypes.data, stats.ctypes.data) == 0
    return out, stats


def _edge_descriptors(P: int, L: int, NW: int, seed: int) -> Windows:
    """Tiles at every start alignment, before the planes, across their
    start and end and past them, with wend before, at and after the
    window, inside a vector and past L."""
    g = np.random.default_rng(seed)
    starts, ends = [], []
    for ws in list(range(-NW - 6, 9)) + list(range(L - NW - 5, L + 6)):
        for we in (ws - 1, ws, ws + 1, ws + 3, ws + 5, ws + NW - 2,
                   ws + NW, ws + NW + 3, L - 1, L, L + 9):
            starts.append(ws)
            ends.append(we)
    for _ in range(64):
        ws = int(g.integers(-NW, L))
        starts.append(ws)
        ends.append(int(g.integers(ws - 2, L + 8)))
    planes = g.integers(-2**31, 2**31, (P, L), dtype=np.int64).astype(np.int32)
    return Windows(torch.from_numpy(planes), torch.tensor(starts),
                   torch.tensor(ends), NW)


@pytest.mark.parametrize("P,L,NW", [
    (4, 64, 9), (4, 20, 1), (4, 32, 37), (9, 28, 6), (4, 8, 2), (9, 4, 5),
    (9, 64, 12), (4, 96, 64), (4, 12, 3), (4, 4, 1), (4, 4, 4), (9, 8, 3),
    (4, 40, 7), (9, 36, 10), (4, 128, 33), (9, 16, 17), (4, 24, 11),
    (9, 48, 2),
])
def test_kernel_read_equals_plain(P, L, NW):
    win = _edge_descriptors(P, L, NW, P + L + NW)
    got, (loads, outside) = _host_read(_host(), win)
    np.testing.assert_array_equal(got, _gathered(win))
    assert loads > 0 and outside == 0
    assert sorted({int(s) % 4 for s in win.wstart}) == [0, 1, 2, 3]


@pytest.mark.parametrize("m,k,alpha,n,target,steps", [
    (23, 3, 0.5, 3001, 16, 7),  # the tail tile; pieces with overshoot
    (120, 10, 0.1, 2999, 8, 101),  # the 'N' overlay; a long overshoot
    (120, 10, 0.5, 2500, None, 0),  # halo > W and the tail tile
])
def test_kernel_read_on_engine_descriptors(m, k, alpha, n, target, steps,
                                           monkeypatch):
    """The host read on what the engines hand the kernels: the single
    engine's tiles, a text set's pieces."""
    _, inp = _engine_inputs(m, k, alpha, n, m + n, target, monkeypatch)
    lib = _host()
    got, stats = _host_read(lib, inp.windows)
    np.testing.assert_array_equal(got, _gathered(inp.windows))
    assert stats[1] == 0
    rng = np.random.default_rng(steps)
    texts = [rng.choice(BASES, int(n)) for n in rng.integers(0, 900, 12)]
    ts = batch.TextSet(texts, "cpu")
    pp = ts.piece_plan(27, 256, steps)
    win = ts.descriptor(profiles.Iupac(), pp, True, 0, pp.T)
    got, stats = _host_read(lib, win)
    np.testing.assert_array_equal(got, _gathered(win))
    assert stats[1] == 0


def test_kernel_read_refuses_unaligned_rows():
    lib = _host()
    planes = np.zeros((4, 6), np.int32)
    ws = np.zeros(1, np.int64)
    out = np.zeros((2, 4, 1), np.int32)
    stats = np.zeros(2, np.int64)
    assert lib.sassy_window_read_host(
        planes.ctypes.data, 6, 4, ws.ctypes.data, ws.ctypes.data, 1, 2,
        out.ctypes.data, stats.ctypes.data) == 1
