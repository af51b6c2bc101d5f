"""The text set's pack on the CPU: the batched engine's preparation of a
strand's planes.

``batch.TextSet.planes`` is one ``batch.pack_set`` over the texts' bytes,
uploaded once and concatenated (``myers_torch._upload_set``): its plain
version ``pack_set_plain`` for a set on the CPU, the kernel
``myers_cuda.pack_set`` (``csrc/pack.cu``, its per-word code in
``csrc/pack.cuh``) for one on a CUDA device. Here:

- the plain version equals the JAX package text by text, bit for bit (its
  jitted ``pack``, then ``reverse_planes`` for the reverse strand, then
  ``overlay_n_tail`` for the overshoot), and the pieces' windows equal its
  host packing ``_pack_pieces_np`` of the (reversed) texts;
- a g++ build of the kernel's code (``tests/torch_pack_host.cc``: its
  warps one after another, each finding its words' texts as the kernel
  does, the shared-memory staging emulated lane by lane) equals the plain
  version on the same inputs, aligned or not, with the texts in any order
  and garbage between them, over one warp or many, and loads no byte
  outside a text; a word's text costs O(1) stagings amortised and a
  warp's range one search of the table;
- the staged upload of a set fills the pinned buffers from the texts'
  own arrays, chunk by chunk, with no host array of the set;
- the wrapper's refusals, before any build.

The cases: DNA, IUPAC and both ascii profiles; both strands; 0, 7 and 101
overshoot steps (IUPAC, the one profile with overhang); texts of 0, 1, 31,
32 and 33 bytes and random lengths; all 256 byte values. The kernel runs
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import ctypes
import os
import threading
import tracemalloc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sassy_tpu import profiles as ref_profiles
from sassy_tpu.ops import batch as ref_batch
from sassy_tpu.ops import myers_xla
from sassy_tpu_torch import profiles
from sassy_tpu_torch.ops import batch, myers_cuda, myers_torch

# each package gets its own profile objects
PROFILES = {
    "dna": (profiles.Dna(), ref_profiles.Dna()),
    "iupac": (profiles.Iupac(), ref_profiles.Iupac()),
    "ascii_fold": (profiles.Ascii(case_sensitive=False),
                   ref_profiles.Ascii(case_sensitive=False)),
    "ascii": (profiles.Ascii(case_sensitive=True),
              ref_profiles.Ascii(case_sensitive=True)),
}

#: (profile, steps): overshoot steps only where the profile has overhang
CASES = [("dna", 0), ("iupac", 0), ("iupac", 7), ("iupac", 101),
         ("ascii_fold", 0), ("ascii", 0)]

LENGTHS = [0, 1, 31, 32, 33, 0, 64, 95, 1000]


def _texts(seed: int) -> list[np.ndarray]:
    """Texts of the edge lengths and random ones, of all 256 byte values."""
    rng = np.random.default_rng(seed)
    lens = LENGTHS + rng.integers(0, 700, 8).tolist()
    return [rng.integers(0, 256, n, dtype=np.uint8) for n in lens]


def _jax_planes(ref_prof, text: np.ndarray, reverse: bool, steps: int,
                gw: int) -> np.ndarray:
    """One text's (P[+1], gw) planes as the JAX package makes them: the
    jitted pack, ``reverse_planes`` for the reverse strand, then the
    overshoot's ``overlay_n_tail``."""
    ker = myers_xla._kernels()
    n = len(text)
    buf = np.zeros(gw * 32, np.uint8)
    buf[:n] = text
    nw, nb = np.int32(n // 32), np.int32(n % 32)
    got = ker["pack_jit"](
        jnp.asarray(buf), nw, nb, planes=ref_prof.planes,
        with_valid=ref_prof.eq_mode == "ascii", mode=ref_prof.pack_mode,
        shift=ref_prof.pack_shift, mask=ref_prof.pack_mask,
        pmasks=tuple(ref_prof.pack_plane_masks),
        fold=ref_prof.pack_fold_case)
    if reverse:
        got = ker["reverse_planes"](got, nw, nb)
    if steps:
        e = n + steps
        got = ker["overlay"](got, nw, nb, np.int32(e // 32),
                             np.int32(e % 32))
    return np.asarray(got).view(np.int32)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name,steps", CASES)
def test_plain_pack_set_equals_jax(name, steps, reverse):
    """``TextSet.planes`` on the CPU (one ``pack_set_plain``) holds each
    text's words equal to the JAX package's planes of that text, the rest
    of them zero, and zero from the set's last word on."""
    prof, ref_prof = PROFILES[name]
    texts = _texts(steps + 3 * reverse)
    ts = batch.TextSet(texts, "cpu")
    calls = batch.pack_set_plain.calls
    got = ts.planes(prof, reverse, steps).numpy()
    assert batch.pack_set_plain.calls == calls + 1
    nw, wofs = ts.layout(steps)
    assert got.shape == (prof.planes + (name.startswith("ascii")),
                         myers_torch.aligned_words(wofs[-1] + 1))
    gw = int(nw.max()) + 2
    for t, text in enumerate(texts):
        want = _jax_planes(ref_prof, text, reverse, steps, gw)
        assert not want[:, nw[t]:].any()
        np.testing.assert_array_equal(
            got[:, wofs[t] : wofs[t + 1]], want[:, : nw[t]],
            err_msg=f"text {t} of {len(text)} bytes")
    assert not got[:, wofs[-1]:].any()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name,steps", [c for c in CASES if c[1] < 100])
def test_piece_windows_equal_pack_pieces_np(name, steps, reverse):
    """The pieces' windows over the set's planes equal the JAX package's
    host packing of the texts (reversed by ``_texts_for``), all 256 byte
    values, overshoot 'N's included."""
    prof, ref_prof = PROFILES[name]
    texts = _texts(11 + steps + reverse)
    ts = batch.TextSet(texts, "cpu")
    halo, w_chars = 27, 256
    pp = ts.piece_plan(halo, w_chars, steps)
    pieces = ref_batch._plan_pieces(ts.lens, steps, w_chars, halo)
    want = ref_batch._pack_pieces_np(
        ref_prof, ref_batch.TextSet(texts)._texts_for(reverse), pieces,
        w_chars, steps,
    ).transpose(2, 0, 1).view(np.int32)
    assert pp.T == len(pieces)
    np.testing.assert_array_equal(
        ts.windows(prof, pp, reverse, 0, pp.T).numpy(), want)


def test_textset_planes_cached_per_strand_and_steps():
    """One plain set pack per (profile, strand, steps), then the cache;
    the bytes are laid out once, concatenated, each byte once."""
    texts = _texts(5)
    ts = batch.TextSet(texts, "cpu")
    iupac = profiles.Iupac()
    calls = batch.pack_set_plain.calls
    for _ in range(2):
        for reverse in (False, True):
            for steps in (0, 7):
                ts.planes(iupac, reverse, steps)
    assert batch.pack_set_plain.calls == calls + 4
    data = ts.data()
    assert data.dtype == torch.uint8 and data.shape == (sum(ts.lens),)
    np.testing.assert_array_equal(data.numpy(), np.concatenate(texts))
    starts, lens, wofs = ts.tables(7)
    assert starts.tolist() == np.cumsum([0] + ts.lens[:-1]).tolist()
    assert lens.tolist() == ts.lens
    assert wofs.tolist() == ts.layout(7)[1].tolist()


def test_pack_set_cpu_runs_the_plain_version(monkeypatch):
    """On CPU bytes the entry point calls its plain version and launches
    nothing (no build either)."""
    monkeypatch.setattr(myers_cuda, "_lib", lambda: pytest.fail("built"))
    ts = batch.TextSet(_texts(2), "cpu")
    args = (ts.data(), *ts.tables(0), ts.words() + 4, profiles.Dna())
    calls, launches = batch.pack_set_plain.calls, myers_cuda.pack_set.launches
    got = batch.pack_set(*args, reverse=True)
    assert batch.pack_set_plain.calls == calls + 1
    assert myers_cuda.pack_set.launches == launches
    assert torch.equal(got, batch.pack_set_plain(*args, reverse=True))
    with pytest.raises(ValueError, match="no overhang"):
        batch.pack_set_plain(*args, steps=7)


# ---------------------------------------------------------------------------
# the kernel's per-word code, built with g++


def _host():
    """The host program over pack.cuh, built with g++ into
    build/sassy_tpu_torch/."""
    from sassy_tpu_torch import gxx

    here = os.path.dirname(os.path.abspath(__file__))
    csrc = myers_cuda.CSRC
    lib = ctypes.CDLL(str(gxx.build(
        "pack_host", [os.path.join(here, "torch_pack_host.cc"),
                      csrc / "pack.cuh"],
        ["-std=c++17", "-O1", "-shared", "-fPIC", f"-I{csrc}"])))
    ptr, num, big = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sassy_pack_set_host.argtypes = (
        [ptr, big] + [ptr] * 3 + [big, ptr, big, big] + [num] * 6
        + [ctypes.POINTER(ctypes.c_uint), num, big, ptr])
    lib.sassy_pack_set_host.restype = num
    return lib


def _host_set(lib, data: np.ndarray, starts, lens, wofs, width: int, prof,
              reverse: bool, steps: int, warps: int = 4):
    """The host program on one set, as the wrapper drives the kernel, its
    words split over ``warps`` warps: ((P[+1], width) int32, the return
    code, (loads, loads outside every text, vector loads, stagings,
    search rounds))."""
    with_valid = prof.eq_mode == "ascii"
    out = np.full((prof.planes + with_valid, width), -7, np.int32)
    pm = (ctypes.c_uint * myers_cuda.PACK_MAX_PLANES)(
        *[int(v) for v in prof.pack_plane_masks])
    stats = np.zeros(5, np.int64)
    tabs = [np.ascontiguousarray(a, np.int64) for a in (starts, lens, wofs)]
    err = lib.sassy_pack_set_host(
        data.ctypes.data if len(data) else None, len(data),
        *[a.ctypes.data for a in tabs], len(tabs[0]), out.ctypes.data,
        width, steps, int(reverse), prof.planes, int(with_valid),
        myers_cuda.PACK_MODES[prof.pack_mode], prof.pack_shift,
        prof.pack_mask, pm, int(prof.pack_fold_case), warps,
        stats.ctypes.data)
    return out, err, stats


def _at(buf: np.ndarray, offset: int, n: int) -> np.ndarray:
    """n bytes of buf from the first 16-byte aligned address on, plus
    ``offset``."""
    skip = -buf.ctypes.data % 16
    return buf[skip + offset : skip + offset + n]


def _layouts(texts, seed: int):
    """(label, data, starts): the set concatenated at an aligned address,
    one byte past it, and scattered in a shuffled order with random bytes
    between and around the texts."""
    rng = np.random.default_rng(seed)
    whole = np.concatenate(texts)
    offs = np.concatenate([[0], np.cumsum([len(t) for t in texts])])
    out = []
    for label, offset in (("aligned", 0), ("unaligned", 1)):
        data = _at(np.zeros(len(whole) + 32, np.uint8), offset, len(whole))
        data[:] = whole
        out.append((label, data, offs[:-1]))
    gaps = rng.integers(0, 40, len(texts) + 1)
    order = rng.permutation(len(texts))
    data = rng.integers(0, 256, len(whole) + int(gaps.sum()), dtype=np.uint8)
    starts = np.zeros(len(texts), np.int64)
    at = int(gaps[0])
    for t, gap in zip(order, gaps[1:]):
        starts[t] = at
        data[at : at + len(texts[t])] = texts[t]
        at += len(texts[t]) + int(gap)
    out.append(("scattered", data, starts))
    return out


@pytest.mark.parametrize("warps", [1, 7])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name,steps", CASES)
def test_host_pack_set_equals_plain(name, steps, reverse, warps):
    """The kernel's code equals the plain version on the same bytes and
    tables, for each layout, its words in one warp's range or split over
    seven; no load leaves a text."""
    prof = PROFILES[name][0]
    texts = _texts(100 + steps + reverse)
    ts = batch.TextSet(texts, "cpu")
    lens = np.asarray(ts.lens, np.int64)
    wofs = ts.layout(steps)[1]
    width = myers_torch.aligned_words(int(wofs[-1]) + 1) + 4
    lib = _host()
    for label, data, starts in _layouts(texts, steps + reverse):
        want = batch.pack_set_plain(
            torch.from_numpy(data.copy()), torch.from_numpy(starts.copy()),
            torch.from_numpy(lens), torch.from_numpy(wofs), width, prof,
            reverse, steps).numpy()
        got, err, (loads, outside, wide, _, _) = _host_set(
            lib, data, starts, lens, wofs, width, prof, reverse, steps,
            warps)
        assert err == 0
        np.testing.assert_array_equal(got, want, err_msg=label)
        # words inside a text take the vector loads, its ends byte loads;
        # a buffer not 16-byte aligned is read a byte at a time
        assert outside == 0 and wide < loads, label
        assert (wide == 0) == (label == "unaligned"), label


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name,steps", [("dna", 0), ("iupac", 7),
                                        ("ascii_fold", 0)])
def test_host_pack_set_every_length_and_alignment(name, steps, reverse):
    """Texts of every length 0..69 after every misalignment 0..15 (the
    vector loads' funnel shifts and the byte loads at the ends)."""
    prof = PROFILES[name][0]
    rng = np.random.default_rng(69)
    texts = [rng.integers(0, 256, n, dtype=np.uint8) for n in range(70)]
    whole = np.concatenate(texts)
    lens = np.arange(70, dtype=np.int64)
    wofs = batch.TextSet(texts, "cpu").layout(steps)[1]
    width = myers_torch.aligned_words(int(wofs[-1]) + 1)
    lib = _host()
    for shift in range(16):
        data = _at(rng.integers(0, 256, len(whole) + 64, dtype=np.uint8), 0,
                   len(whole) + shift)
        data[shift:] = whole
        starts = shift + np.concatenate([[0], np.cumsum(lens)[:-1]])
        want = batch.pack_set_plain(
            torch.from_numpy(data.copy()), torch.from_numpy(starts),
            torch.from_numpy(lens), torch.from_numpy(wofs), width, prof,
            reverse, steps).numpy()
        got, err, (_, outside, wide, _, _) = _host_set(
            lib, data, starts, lens, wofs, width, prof, reverse, steps)
        assert err == 0 and outside == 0 and wide > 0
        np.testing.assert_array_equal(got, want, err_msg=f"shift {shift}")


def _tiny_texts(seed: int) -> list[np.ndarray]:
    """Many texts of 1-3 words (1-96 bytes), runs of empty texts (one of
    40, more than a warp's 32 lanes), and one long text of 300 words that
    crosses a block's 256 words and the warps' range edges."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 97, 700).tolist()
    lens[100:100] = [0] * 40
    lens[400:400] = [0, 0, 1, 0, 32, 0]
    lens[550:550] = [300 * 32 - 5]
    lens = [0] * 3 + lens + [0] * 2
    return [rng.integers(0, 256, n, dtype=np.uint8) for n in lens]


@pytest.mark.parametrize("warps", [1, 3, 64, 1000])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name,steps", [("dna", 0), ("iupac", 7),
                                        ("iupac", 101)])
def test_host_pack_set_many_tiny_texts(name, steps, reverse, warps):
    """Hundreds of 1-3 word texts, runs of empty ones and a text across the
    warps' range edges, over 1, 3, 64 and 1,000 warps (ranges of 32
    words), aligned and not: equal to the plain version, no load outside a
    text, and the texts found in O(1) stagings a warp step (a run of 40
    empty texts within a warp's 32 words takes a second round) and a
    range's first text in a few rounds of 32 probes."""
    prof = PROFILES[name][0]
    texts = _tiny_texts(7 + steps + reverse)
    ts = batch.TextSet(texts, "cpu")
    lens = np.asarray(ts.lens, np.int64)
    wofs = ts.layout(steps)[1]
    width = myers_torch.aligned_words(int(wofs[-1]) + 1) + 40
    per = -(-(-(-width // warps)) // 32) * 32
    ranges = -(-width // per)
    steps_taken = sum(-(-min(per, width - w) // 32)
                      for w in range(0, width, per))
    lib = _host()
    for label, data, starts in _layouts(texts, 3 + steps)[:2]:
        want = batch.pack_set_plain(
            torch.from_numpy(data.copy()), torch.from_numpy(starts.copy()),
            torch.from_numpy(lens), torch.from_numpy(wofs), width, prof,
            reverse, steps).numpy()
        got, err, (_, outside, _, stagings, rounds) = _host_set(
            lib, data, starts, lens, wofs, width, prof, reverse, steps,
            warps)
        assert err == 0 and outside == 0, label
        np.testing.assert_array_equal(got, want, err_msg=label)
        assert stagings <= steps_taken + 2 * ranges, label
        assert rounds <= 5 * ranges, label


@pytest.mark.parametrize("reverse", [False, True])
def test_host_pack_set_one_text_stages_once_a_warp(reverse):
    """One text over eight warps: each warp stages once, at its range's
    first step, and then keeps the text to its range's end; the last warp
    once more, where its words pass the text's end."""
    prof = PROFILES["dna"][0]
    rng = np.random.default_rng(8)
    text = _at(rng.integers(0, 256, 40_100, dtype=np.uint8), 0, 40_000)
    wofs = np.asarray([0, 1250], np.int64)
    width = 1256
    want = batch.pack_set_plain(
        torch.from_numpy(text.copy()), torch.zeros(1, dtype=torch.int64),
        torch.tensor([40_000]), torch.from_numpy(wofs), width, prof,
        reverse).numpy()
    got, err, (loads, outside, wide, stagings, rounds) = _host_set(
        lib := _host(), text, [0], [40_000], wofs, width, prof, reverse, 0,
        warps=8)
    assert err == 0 and outside == 0 and wide == loads == 1250
    np.testing.assert_array_equal(got, want)
    assert stagings == 8 + 1 and rounds <= 16
    del lib


def test_host_pack_set_words_before_the_first_text():
    """A set whose first text starts at plane word 5 (wofs[0] = 5): the
    five words before it are zero in every plane and the rest are the set
    packed from word 0, over one warp and over many."""
    prof = PROFILES["iupac"][0]
    texts = _texts(21)
    ts = batch.TextSet(texts, "cpu")
    lens = np.asarray(ts.lens, np.int64)
    wofs = ts.layout(7)[1]
    width = myers_torch.aligned_words(int(wofs[-1]) + 1)
    data = np.concatenate(texts)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    want, err, _ = _host_set(_host(), data, starts, lens, wofs, width, prof,
                             True, 7, warps=1)
    assert err == 0
    for warps in (1, 9):
        got, err, (_, outside, _, _, _) = _host_set(
            _host(), data, starts, lens, wofs + 5, width + 5, prof, True, 7,
            warps)
        assert err == 0 and outside == 0
        assert not got[:, :5].any()
        np.testing.assert_array_equal(got[:, 5:], want)


def test_host_pack_set_past_2_31():
    """Byte offsets past 2^31: a text whose table puts it 2^31 + 5 bytes
    into a buffer that starts that far before it (only the text's bytes
    are touched) packs as the same text at offset 0, both strands."""
    prof = PROFILES["iupac"][0]
    text = np.random.default_rng(31).integers(0, 256, 1001, dtype=np.uint8)
    base = (1 << 31) + 5
    pm = (ctypes.c_uint * 8)(*[int(v) for v in prof.pack_plane_masks])
    lib = _host()
    for reverse in (False, True):
        want, err, _ = _host_set(lib, text, [0], [1001], [0, 32], 36, prof,
                                 reverse, 7)
        assert err == 0
        out = np.full((prof.planes, 36), -7, np.int32)
        tabs = [np.asarray(a, np.int64) for a in ([base], [1001], [0, 32])]
        stats = np.zeros(5, np.int64)
        assert lib.sassy_pack_set_host(
            text.ctypes.data - base, base + 1001,
            *[a.ctypes.data for a in tabs], 1, out.ctypes.data, 36, 7,
            int(reverse), prof.planes, 0, 0, prof.pack_shift,
            prof.pack_mask, pm, 0, 4, stats.ctypes.data) == 0
        np.testing.assert_array_equal(out, want)
        assert stats[0] > 0 and stats[1] == 0


def test_host_pack_set_refuses_bad_arguments():
    """The host program (like the kernel's C entry point) refuses no
    output words, negative steps, more than 8 planes, a table5 shift past
    7, and texts without tables (and no warps)."""
    lib = _host()
    prof = PROFILES["iupac"][0]
    pm = (ctypes.c_uint * 8)(*[int(v) for v in prof.pack_plane_masks])
    out = np.zeros((9, 8), np.int32)
    data = np.zeros(64, np.uint8)
    tab = np.zeros(2, np.int64)
    stats = np.zeros(5, np.int64)

    def call(width=8, steps=0, planes=4, shift=0, tables=True, warps=1):
        t = tab.ctypes.data if tables else None
        return lib.sassy_pack_set_host(
            data.ctypes.data, 64, t, t, tab.ctypes.data, 1, out.ctypes.data,
            width, steps, 0, planes, 0, 0, shift, 31, pm, 0, warps,
            stats.ctypes.data)

    assert call() == 0
    for bad in (dict(width=0), dict(steps=-1), dict(planes=9),
                dict(shift=8), dict(tables=False), dict(warps=0)):
        assert call(**bad) == 1, bad


def test_pack_set_bound_counts_the_tables():
    """``diagnostics.pack_bound`` of a text set's pack: the bytes, the
    planes and the tables (three int64 a text and the total), each once;
    a one-text pack's bound is unchanged."""
    from sassy_tpu_torch import diagnostics

    one = diagnostics.pack_bound(100, 4, False, gw=10)
    assert one["bytes"] == 260
    got = diagnostics.pack_bound(100, 4, False, gw=10, texts=3)
    assert got["bytes"] == 260 + 8 * 10
    assert got["bound_ms"] > one["bound_ms"]


@pytest.mark.parametrize("bad", ["dtype", "dim", "strided", "table dtype",
                                 "table shape", "wofs shape", "width",
                                 "steps", "no overhang", "device"])
def test_pack_set_kernel_refuses_before_any_build(monkeypatch, bad):
    """The kernel wrapper raises ValueError on inputs it does not take,
    before building or launching anything."""
    monkeypatch.setattr(myers_cuda, "_lib", lambda: pytest.fail("built"))
    meta = torch.device("meta")
    data = torch.zeros(100, dtype=torch.uint8, device=meta)
    starts = torch.zeros(3, dtype=torch.int64, device=meta)
    wofs = torch.zeros(4, dtype=torch.int64, device=meta)
    args = dict(data=data, starts=starts, lens=starts, wofs=wofs, width=8,
                profile=profiles.Iupac(), steps=0)
    args.update({
        "dtype": dict(data=data.to(torch.int32)),
        "dim": dict(data=data.view(10, 10)),
        "strided": dict(data=data[::2]),
        "table dtype": dict(lens=starts.to(torch.int32)),
        "table shape": dict(starts=starts[:2]),
        "wofs shape": dict(wofs=wofs[:3]),
        "width": dict(width=0),
        "steps": dict(steps=-1),
        "no overhang": dict(profile=profiles.Dna(), steps=7),
        "device": {},  # all else right: meta is no CUDA device
    }[bad])
    launches = myers_cuda.pack_set.launches
    with pytest.raises(ValueError):
        myers_cuda.pack_set(**args)
    assert myers_cuda.pack_set.launches == launches


# ---------------------------------------------------------------------------
# the staged upload of a set, with a staging of plain CPU tensors


class _HostStaging:
    """The staging's interface on the CPU; records each send."""

    def __init__(self, nbytes: int):
        self.bufs = [torch.full((nbytes,), 0xAA, dtype=torch.uint8)
                     for _ in range(2)]
        self.lock = threading.Lock()
        self.sends = []
        self.out = None

    def begin(self, out):
        self.out = out

    def wait(self, slot):
        pass

    def send(self, slot, dst, n):
        dst.copy_(self.bufs[slot][:n])
        self.sends.append((slot, dst.data_ptr() - self.out.data_ptr(), n))

    def end(self, out):
        pass


@pytest.mark.parametrize("chunk", [7, 8, 64, 1 << 12])
def test_staged_set_upload_equals_concatenation(monkeypatch, chunk):
    """Chunk edges inside texts, empty texts (first, last, in runs), a
    text longer than several chunks, a read-only text (bytes) and a
    reversed view: the device bytes are the concatenation, sent chunk by
    chunk in order, alternating the buffers."""
    monkeypatch.setattr(myers_torch, "STAGE_BYTES", chunk)
    staging = _HostStaging(chunk)
    monkeypatch.setattr(myers_torch, "_staging_for", lambda device: staging)
    rng = np.random.default_rng(chunk)
    texts = [np.zeros(0, np.uint8), rng.integers(0, 256, 5, np.uint8),
             np.zeros(0, np.uint8), np.zeros(0, np.uint8),
             rng.integers(0, 256, 3 * chunk + 5, np.uint8),
             bytes(rng.integers(0, 256, 13, np.uint8)),
             rng.integers(0, 256, 40, np.uint8)[::-1],
             rng.integers(0, 256, 1, np.uint8), np.zeros(0, np.uint8)]
    ts = batch.TextSet(texts, "cpu")
    got = ts.data()
    want = np.concatenate([np.frombuffer(t, np.uint8) if isinstance(t, bytes)
                           else t for t in texts])
    np.testing.assert_array_equal(got.numpy(), want)
    n = len(want)
    assert staging.sends == [(i % 2, c0, min(chunk, n - c0))
                             for i, c0 in enumerate(range(0, n, chunk))]


def test_staged_set_upload_holds_no_host_array_of_the_set(monkeypatch):
    """16 MiB of 4,096 texts in 256 KiB chunks: the host memory Python and
    numpy allocate during the upload (the texts' offsets, the lists of
    views, ~0.2 MiB) stays under 1 MiB, a sixteenth of the set (the device
    buffer here is a CPU tensor, which tracemalloc does not see)."""
    chunk = 1 << 18
    monkeypatch.setattr(myers_torch, "STAGE_BYTES", chunk)
    staging = _HostStaging(chunk)
    monkeypatch.setattr(myers_torch, "_staging_for", lambda device: staging)
    rng = np.random.default_rng(4)
    texts = list(rng.integers(0, 256, (4096, 4096), np.uint8))
    tracemalloc.start()
    try:
        got = myers_torch._upload_set(texts, torch.device("cpu"))
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20
    np.testing.assert_array_equal(got.numpy(), np.concatenate(texts))
    assert len(staging.sends) == (4096 * 4096) // chunk
