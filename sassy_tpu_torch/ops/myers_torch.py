"""The single-pattern search pipeline in PyTorch.

Port of ``sassy_tpu/ops/myers_xla.py``: text bytes -> P bit-planes of
32-position words (``pack``: the pack kernel of ``myers_cuda`` on the
card, ``pack_plain`` its plain version; with overhang,
``overlay_n_tail`` sets the 'N' positions past the text end) ->
halo-tiled windows, described and not copied (``Windows``: each tile's
first plane word and the end of the words it may read;
``tile_windows``) -> the transposed Myers'99 word scan (the CUDA kernels
of ``myers_cuda``, which read each window straight from the planes;
``windows_plain`` gathers the (NW, P, T) windows for their plain
versions, ``scan_core``) -> candidate selection (``minima``) -> a sorted
host list of (end position, cost).

Two paths, as in the reference engine:

- word level (no overhang, or an overshoot span of at most three words):
  the q1meta scan with selection metadata and
  ``minima.select_words_chained`` (the cross-tile state chain inside the
  selection); with overhang one extra tail tile owns
  the overshoot span;
- position level (a longer overshoot span): the q1 scan and
  ``minima.select_candidates`` over every position.

Without overhang, a pattern with ``plan.suffix_rows`` > 0 whose suffix
scan saves at least ``plan.HIER_MIN_SAVED_PAIRS`` (row, word) pairs first
runs the hierarchical suffix prefilter: q1meta with the pattern's last rows flags the tiles that can
hold a match, and the word-level path runs on those tiles only.

``TorchEngine.candidates_async`` runs that device work on the one dispatch
thread that both engines share (``dispatch_async``), on the caller's
current CUDA stream, and returns a ``finish()`` that waits for the sorted
candidate list; ``prepare`` keeps the prepared texts of live read-only
source arrays (``_IdCache``), so a second search over the same array
reuses its planes and window descriptors; ``prepare_strands`` prepares
both strands of a text from one upload of its bytes (the reverse strand
packed backwards by the text set's pack kernel: ``pack_backwards``), and
keeps the pair the same way.

Device tensors hold uint32 bit words as int32; the plain versions compute
on int64 values masked to 32 bits (see ``minima.u32``).
"""

from __future__ import annotations

import contextlib
import threading
import warnings
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np
import torch

from .. import gxx, semantics, spans
from ..profiles import Profile, as_bytes_array
from . import minima, myers_cuda, plan
from .bitpack import WORD_BITS
from .minima import FULL, i32, u32
from .plan import (
    TAIL_RESERVE_WORDS,
    _bucket_rows,
    _bucket_words,
    _masks_pure_np,
    cdiv,
    halo_words,
    pattern_inputs_np,
    plan_tiles,
)

__all__ = [
    "pack",
    "pack_plain",
    "overlay_n_tail",
    "pack_backwards",
    "Windows",
    "windows_plain",
    "tile_windows",
    "build_windows",
    "scan_core",
    "pure_plane_index",
    "PreparedText",
    "ScanInputs",
    "TorchEngine",
    "state_from_numpy",
    "engine_device",
    "dispatch_async",
]

#: Words ``pack_plain`` packs per pass: the per-char expansion of a chunk
#: takes 4 bytes per char, so 2^20 words keep it at 128 MiB for any text
#: size (the kernel needs no chunks).
PACK_CHUNK_WORDS = 1 << 20

_WORKER: ThreadPoolExecutor | None = None
_WORKER_LOCK = threading.Lock()


def _worker() -> ThreadPoolExecutor:
    """The one dispatch thread of both engines: dispatches run in the order
    submitted, one at a time, so a text's caches (a ``PreparedText``'s
    window descriptors, a ``TextSet``'s planes) are touched by one thread
    at once."""
    global _WORKER
    with _WORKER_LOCK:
        if _WORKER is None:
            _WORKER = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="sassy_tpu_torch-dispatch")
        return _WORKER


def dispatch_async(device: torch.device, fn) -> Future:
    """Run ``fn()`` on the dispatch thread, on the caller's current CUDA
    stream (on the CPU, as it is). The host waits inside ``fn`` (each
    ``torch.nonzero`` waits for the scan before it), so the caller's
    thread is free meanwhile; the future raises ``fn``'s errors. While a
    profiler runs, the job's spans go into the caller's bound record, under
    a "dispatch" span (the caller's ``enqueue`` span holds this call)."""
    stream = (torch.cuda.current_stream(device) if device.type == "cuda"
              else None)
    rec = spans.handoff()

    def run():
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            if rec is None:
                return fn()
            with spans.bound(rec), spans.span("dispatch"):
                return fn()

    return _worker().submit(run)


def engine_device(device, owner: str) -> torch.device:
    """``device`` as a torch.device; "cuda" without a CUDA device raises
    (no engine runs on the CPU in its place)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{owner}(device='cuda'): no CUDA device")
    return device


def state_from_numpy(*arrays: np.ndarray, device) -> tuple[torch.Tensor, ...]:
    """uint32 numpy state of the reference package (packed planes,
    pattern masks, pad flags, h deltas) -> int32 tensors with the same
    bits on ``device``."""
    return tuple(
        torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32)).to(device)
        for a in arrays
    )


def _signed32(v: int) -> int:
    return v - (1 << 32) if v >= 1 << 31 else v


def pack(text_u8: torch.Tensor, nw: int, nb: int, planes: int,
         with_valid: bool, mode: str, shift: int, mask: int,
         pmasks: tuple, fold: bool, gw: int | None = None) -> torch.Tensor:
    """Raw text bytes -> (P[+1], GW) int32 bit-planes of the engine codes
    (``pack_plain`` says what they hold). Runs ``pack_plain`` for a text on
    the CPU and the pack kernel (``myers_cuda.pack``, ``csrc/pack.cu``) for
    a text on a CUDA device, which raises on inputs it does not take; no
    fallback. ``gw`` defaults to the text's whole words."""
    if text_u8.device.type == "cpu":
        return pack_plain(text_u8, nw, nb, planes, with_valid, mode, shift,
                          mask, pmasks, fold, gw)
    return myers_cuda.pack(text_u8, nw, nb, planes, with_valid, mode, shift,
                           mask, pmasks, fold, gw)


def pack_plain(text_u8: torch.Tensor, nw: int, nb: int, planes: int,
               with_valid: bool, mode: str, shift: int, mask: int,
               pmasks: tuple, fold: bool,
               gw: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the pack kernel. (GW*32,) uint8 raw text
    (or the first bytes of it: a shorter text reads as zero-padded) ->
    (P[+1], GW) int32 bit-planes of the engine codes: bit i of word w of
    plane p = bit p of the code of char 32*w + i. ``mode`` "table5": code
    bit p of byte b = bit ``(b >> shift) & mask`` of ``pmasks[p]``;
    "byte": the (case-folded with ``fold``) byte's own bits. Positions >=
    n = nw*32 + nb are zero; the optional validity plane marks positions
    < n. n arrives split in words and bits, as in the reference, so no
    position needs more than int32. ``gw`` defaults to
    ``len(text_u8) // 32``."""
    pack_plain.calls += 1
    gw = text_u8.shape[0] // WORD_BITS if gw is None else gw
    dev = text_u8.device
    if text_u8.shape[0] < gw * WORD_BITS:
        buf = torch.zeros(gw * WORD_BITS, dtype=torch.uint8, device=dev)
        buf[: text_u8.shape[0]] = text_u8
        text_u8 = buf
    out = torch.empty((planes + int(with_valid), gw), dtype=torch.int32,
                      device=dev)
    byte_w = torch.arange(8, dtype=torch.uint8, device=dev)
    # int32 masks: an arithmetic shift still brings bit idx (<= 31) to bit 0
    pm = torch.tensor([_signed32(int(v)) for v in pmasks], dtype=torch.int32,
                      device=dev)
    for c0 in range(0, gw, PACK_CHUNK_WORDS):
        c1 = min(gw, c0 + PACK_CHUNK_WORDS)
        t = text_u8[c0 * WORD_BITS : c1 * WORD_BITS].to(torch.int32)
        if mode == "byte":
            if fold:
                t = torch.where((t >= 65) & (t <= 90), t + 32, t)
        else:
            t = (t >> shift) & mask  # the truth-table index
        for p in range(planes):
            bits = ((t >> p) if mode == "byte" else (pm[p] >> t)) & 1
            # 8 chars -> one byte, 4 bytes -> one little-endian word
            b8 = (bits.to(torch.uint8).view(-1, 8) << byte_w).sum(
                dim=1, dtype=torch.uint8
            )
            out[p, c0:c1] = b8.view(-1, 4).view(torch.int32).view(-1)
    w = torch.arange(gw, dtype=torch.int64, device=dev)
    lo = torch.where(w < nw, WORD_BITS, torch.where(w > nw, 0, nb))
    nmask = i32(torch.where(lo >= WORD_BITS, FULL, (1 << lo) - 1))
    out[:planes] &= nmask
    if with_valid:
        # the validity plane IS the n-mask
        out[planes] = nmask
    return out


pack_plain.calls = 0


def overlay_n_tail(planes: torch.Tensor, n: int, e: int) -> torch.Tensor:
    """A copy of (P, GW) planes with bits [n, e) set in every plane: 'N',
    which matches everything, for overhang positions past the text end
    (reference search.rs:203). Only the words that hold them change."""
    out = planes.clone()
    w0, w1 = n // WORD_BITS, min(planes.shape[1], cdiv(e, WORD_BITS))
    if w1 <= w0:
        return out
    w = torch.arange(w0, w1, dtype=torch.int64, device=planes.device)

    def below(x):  # mask of bit positions < x within each word
        b = (x - w * WORD_BITS).clamp(0, WORD_BITS)
        return torch.where(b >= WORD_BITS, FULL, (1 << b) - 1)

    out[:, w0:w1] |= i32(below(e) ^ below(n))
    return out


#: Plane rows the scan kernels read are a multiple of this many words,
#: 16-byte aligned: the vector loads of ``csrc/window_read.cuh``.
PLANE_ALIGN_WORDS = 4


def aligned_words(n: int) -> int:
    """n plane words (at least one) rounded up to a multiple of
    ``PLANE_ALIGN_WORDS``."""
    return cdiv(max(n, 1), PLANE_ALIGN_WORDS) * PLANE_ALIGN_WORDS


def align_planes(planes: torch.Tensor) -> torch.Tensor:
    """(P, L) planes whose rows the scan kernels can read: ``planes`` when
    they are contiguous and L is a multiple of ``PLANE_ALIGN_WORDS``, else
    a copy zero-padded to one (a fresh tensor, so aligned)."""
    P, L = planes.shape
    width = aligned_words(L)
    if width == L and planes.is_contiguous():
        return planes
    out = torch.zeros((P, width), dtype=planes.dtype, device=planes.device)
    out[:, :L] = planes
    return out


@dataclass(frozen=True)
class Windows:
    """The windows of T tiles, described and not copied: window word i of
    tile t, plane p, is ``planes[p, wstart[t] + i]`` where ``0 <=
    wstart[t] + i < min(wend[t], L)``, and 0 otherwise. What the scan
    kernels read (``csrc/window_read.cuh``); ``gather`` makes the (NW, P,
    T) window tensor of their plain versions (``windows_plain``)."""

    planes: torch.Tensor  # (P, L) int32
    wstart: torch.Tensor  # (T,) int64 plane word of window word 0
    wend: torch.Tensor  # (T,) int64 exclusive end of the words it may read
    NW: int

    @property
    def shape(self) -> tuple[int, int, int]:
        """(NW, P, T), the shape of the windows it describes."""
        return self.NW, self.planes.shape[0], self.wstart.shape[0]

    @property
    def device(self) -> torch.device:
        return self.planes.device

    def take(self, ids: torch.Tensor) -> "Windows":
        """The windows of the tiles ``ids`` alone, in that order."""
        return replace(self, wstart=self.wstart[ids], wend=self.wend[ids])

    def gather(self) -> torch.Tensor:
        """The (NW, P, T) int32 windows (``windows_plain``)."""
        return windows_plain(self.planes, self.wstart, self.wend, self.NW)

    @classmethod
    def of(cls, windows: torch.Tensor) -> "Windows":
        """The descriptor of an (NW, P, T) window tensor's own words: tile
        t's window laid out as plane words [t NW, (t + 1) NW)."""
        NW, P, T = windows.shape
        planes = align_planes(windows.permute(1, 2, 0).reshape(P, T * NW))
        wstart = torch.arange(T, dtype=torch.int64,
                              device=windows.device) * NW
        return cls(planes, wstart, wstart + NW, NW)


def windows_plain(planes: torch.Tensor, wstart: torch.Tensor,
                  wend: torch.Tensor, NW: int) -> torch.Tensor:
    """Plain version of the scan kernels' window read: (P, L) planes and
    (T,) int64 ``wstart``/``wend`` -> the (NW, P, T) int32 windows, word i
    of tile t ``planes[:, wstart[t] + i]`` where ``0 <= wstart[t] + i <
    min(wend[t], L)``, else 0. One gather."""
    windows_plain.calls += 1
    P, L = planes.shape
    i = wstart[None, :] + torch.arange(NW, dtype=torch.int64,
                                       device=planes.device)[:, None]
    keep = (i >= 0) & (i < wend.clamp(max=L)[None, :])
    got = planes[:, i.clamp(0, max(L - 1, 0))]
    return torch.where(keep[None], got, 0).permute(1, 0, 2).contiguous()


windows_plain.calls = 0


def tile_windows(planes: torch.Tensor, T: int, W: int, halo: int) -> Windows:
    """The halo-tiled windows of (P, L) planes, NW = W + halo + 1.

    Tile t's window is flat words [t*W - halo, t*W + W]: the halo of left
    context, its W owned words and one right-context word, so the minima
    lookahead at the tile's last owned position reads the true next delta.
    Words before 0 or at/after T*W read as 0 (cost only rises there). Tile
    0's window is the text head [0, NW): it owns the true start and needs
    no halo. Any halo width works, including halo > W.
    """
    L = planes.shape[1]
    NW = W + halo + 1
    t = torch.arange(T, dtype=torch.int64, device=planes.device)
    wstart = torch.where(t == 0, 0, t * W - halo)
    wend = torch.where(t == 0, min(NW, L), min(T * W, L))
    return Windows(planes, wstart, wend, NW)


def build_windows(planes: torch.Tensor, T: int, W: int, halo: int) -> torch.Tensor:
    """(P, GW) planes -> the (NW, P, T) int32 windows of ``tile_windows``,
    gathered (``windows_plain``): for the plain path, the tests and the
    kernel-design tools."""
    return tile_windows(planes, T, W, halo).gather()


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & FULL) >> 24


def pure_plane_index(pmasks: torch.Tensor) -> torch.Tensor:
    """(M,) int32: the last plane whose row mask is non-zero (0 if none),
    the one plane an ACGT-pure row loads."""
    P = pmasks.shape[1]
    planes = torch.arange(P, dtype=torch.int32, device=pmasks.device)
    return ((pmasks != 0).to(torch.int32) * planes).amax(dim=1)


def scan_core(windows, pmasks, is_pad, hp0, hm0, cost0, eq_mode: str):
    """The bit-parallel word scan of Q patterns (plain PyTorch).

    windows: (NW, P, T) int32, word w of plane p for tile t, shared by the
    patterns; pmasks (Q, M, P) ((Q, M, P - 1) for ascii: the validity plane
    has no mask), is_pad (Q, M), hp0/hm0 (Q, M, T) int32 bit patterns;
    cost0 (Q, T) int32.
    ``eq_mode``: "iupac" (eq = pad | OR_p plane & mask), "pure" (eq = pad |
    the row's one plane) or "ascii" (byte equality gated by the validity
    plane). Returns (vp, vm, cost), each (Q, NW, T) int32: the last row's
    vertical delta words and its cost at the start of each word.
    """
    NW, P, T = windows.shape
    Q, M = pmasks.shape[:2]
    # per-row constants as (Q, 1) columns against (Q, T) row state
    pm = u32(pmasks).unsqueeze(-1)  # (Q, M, PM, 1)
    pad = u32(is_pad).unsqueeze(-1)  # (Q, M, 1)
    pidx = (pure_plane_index(pmasks.reshape(Q * M, -1)).view(Q, M).long()
            if eq_mode == "pure" else None)
    hp = u32(hp0)
    hm = u32(hm0)
    cost = cost0.to(torch.int64)
    vp_out = torch.empty((Q, NW, T), dtype=torch.int32, device=windows.device)
    vm_out = torch.empty_like(vp_out)
    cost_out = torch.empty_like(vp_out)
    for w in range(NW):
        x = u32(windows[w])
        vp = torch.zeros_like(cost)
        vm = torch.zeros_like(cost)
        for j in range(M):
            if eq_mode == "pure":
                eq = x[pidx[:, j]] | pad[:, j]
            elif eq_mode == "iupac":
                eq = pad[:, j].expand_as(cost)
                for p in range(P):
                    eq = eq | (x[p] & pm[:, j, p])
            else:
                acc = torch.zeros_like(cost)
                for p in range(P - 1):
                    acc = acc | (x[p] ^ pm[:, j, p])
                eq = ((~acc & FULL) & x[P - 1]) | pad[:, j]
            hp_j = hp[:, j]
            hm_j = hm[:, j]
            # Myers step (reference bitpacking.rs:63-85), 32-bit words
            vx = eq | vm
            eqh = eq | hm_j
            hx = ((((eqh & vp) + vp) & FULL) ^ vp) | eqh
            hp_o = vm | (~(hx | vp) & FULL)
            hm_o = vp & hx
            hp_sh = ((hp_o << 1) & FULL) | hp_j
            hm_sh = ((hm_o << 1) & FULL) | hm_j
            # hp_j/hm_j are views of these rows: overwrite them last
            hp[:, j] = hp_o >> 31
            hm[:, j] = hm_o >> 31
            vp = hm_sh | (~(vx | hp_sh) & FULL)
            vm = hp_sh & vx
        vp_out[:, w] = i32(vp)
        vm_out[:, w] = i32(vm)
        cost_out[:, w] = cost.to(torch.int32)
        cost = cost + _popcount32(vp) - _popcount32(vm)
    return vp_out, vm_out, cost_out


#: bytes of each of the two page-locked staging buffers of an upload to
#: the card
STAGE_BYTES = 64 << 20


class _Staging:
    """Two page-locked host buffers of ``STAGE_BYTES`` and a copy stream
    of one CUDA device, made once a process: an upload's chunks alternate
    between the buffers, so the host copy of chunk i + 1 overlaps the
    direct memory access of chunk i, and an event recorded after each
    chunk's copy guards its buffer's reuse."""

    def __init__(self, device: torch.device):
        self.device = device
        self.bufs = [torch.empty(STAGE_BYTES, dtype=torch.uint8,
                                 pin_memory=True) for _ in range(2)]
        self.events = [torch.cuda.Event() for _ in range(2)]
        self.stream = torch.cuda.Stream(device)
        self.lock = threading.Lock()  # one upload at a time

    def begin(self, out: torch.Tensor) -> None:
        # the copies follow out's allocation on the caller's stream
        self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def wait(self, slot: int) -> None:
        self.events[slot].synchronize()

    def send(self, slot: int, dst: torch.Tensor, n: int) -> None:
        with torch.cuda.stream(self.stream):
            dst.copy_(self.bufs[slot][:n], non_blocking=True)
            self.events[slot].record(self.stream)

    def end(self, out: torch.Tensor) -> None:
        # the caller's stream (the pack) waits for the last copy
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        out.record_stream(self.stream)


_STAGINGS: dict = {}
_STAGINGS_LOCK = threading.Lock()


def _staging_for(device: torch.device) -> _Staging | None:
    """The staging of a CUDA device (made at its first upload), or None:
    other devices take the bytes as they are."""
    if device.type != "cuda":
        return None
    key = torch.cuda.current_device() if device.index is None else device.index
    with _STAGINGS_LOCK:
        got = _STAGINGS.get(key)
        if got is None:
            got = _STAGINGS[key] = _Staging(torch.device("cuda", key))
        return got


def _chunk_pieces(texts, offs: np.ndarray, c0: int, c1: int) -> list:
    """The parts of ``texts`` (byte ``offs[t]`` on of the concatenation is
    text t's first) that bytes c0 .. c1 - 1 of their concatenation hold, in
    order: views, a text crossing an edge cut there."""
    t0 = int(np.searchsorted(offs, c0, side="right")) - 1
    t1 = int(np.searchsorted(offs, c1, side="left"))
    pieces = texts[t0:t1]
    pieces[-1] = pieces[-1][: c1 - int(offs[t1 - 1])]
    pieces[0] = pieces[0][c0 - int(offs[t0]):]
    return pieces


#: the staged upload's host fill, built with g++ at its first use
FILL_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "stage_fill.cc"
_FILL = None
_FILL_LOCK = threading.Lock()


def _fill_entry():
    """``sassy_stage_fill`` of ``FILL_SOURCE``'s library (``gxx.build``
    against the running Python's headers, loaded with ``ctypes.PyDLL``:
    called with the interpreter lock held, it raises what it sets)."""
    global _FILL
    with _FILL_LOCK:
        if _FILL is None:
            import ctypes
            import sysconfig

            paths = sysconfig.get_paths()
            inc = sorted({paths["include"], paths["platinclude"]})
            lib = ctypes.PyDLL(str(gxx.build(
                "libstage_fill", [FILL_SOURCE],
                ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
                 *(f"-I{d}" for d in inc)])))
            fn = lib.sassy_stage_fill
            fn.argtypes = [ctypes.py_object, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
            fn.restype = ctypes.c_int
            _FILL = fn
        return _FILL


def _fill(texts: list, offs: np.ndarray, c0: int, c1: int,
          out: np.ndarray) -> int:
    """Bytes c0 .. c1 - 1 of the concatenation of the host arrays
    ``texts`` (text t from byte ``offs[t]``, int64) into ``out`` ((c1 -
    c0,) uint8, contiguous), on up to one host thread per intra-op thread
    of PyTorch, no more than the texts the range holds, each an equal
    contiguous share of the bytes (``csrc/stage_fill.cc``: the
    interpreter lock is let go while they copy). Returns the threads
    used, once all are done."""
    if not out.flags.c_contiguous or out.shape != (c1 - c0,):
        raise ValueError(f"out must be {c1 - c0} contiguous bytes")
    offs = np.ascontiguousarray(offs, np.int64)
    return _fill_entry()(texts, offs.ctypes.data, c0, c1, out.ctypes.data,
                         torch.get_num_threads())


def _stage_chunks(texts, offs: np.ndarray, out: torch.Tensor, st) -> None:
    """Copy the concatenation of the host arrays ``texts`` (text t at byte
    ``offs[t]``, ``offs[-1]`` bytes in all) into ``out`` through the two
    staging buffers of ``st``, ``STAGE_BYTES`` a chunk, each byte once, in
    order, with no host array of the whole: wait until the buffer's last
    chunk has left it, fill it from the texts' own arrays (a one-piece
    chunk by PyTorch's copy, which uses every intra-op thread; a run of
    texts by ``_fill``, whose threads are all done before the send), send
    it."""
    n = int(offs[-1])
    views = [buf.numpy() for buf in st.bufs]
    st.begin(out)
    for i, c0 in enumerate(range(0, n, STAGE_BYTES)):
        c1 = min(n, c0 + STAGE_BYTES)
        slot = i % 2
        pieces = _chunk_pieces(texts, offs, c0, c1)
        with spans.span("stage_wait"):
            st.wait(slot)
        with spans.span("stage_fill", fill_bytes=c1 - c0):
            if len(pieces) == 1 and pieces[0].strides[0] == 1:
                with warnings.catch_warnings():
                    # a read-only array (bytes) is only read
                    warnings.simplefilter("ignore", UserWarning)
                    st.bufs[slot][: c1 - c0].copy_(
                        torch.from_numpy(pieces[0]))
            else:
                _fill(texts, offs, c0, c1, views[slot][: c1 - c0])
        with spans.span("send"):
            st.send(slot, out[c0:c1], c1 - c0)
    st.end(out)


def _upload(text, device: torch.device) -> torch.Tensor:
    """Raw text bytes -> a contiguous 1-D uint8 tensor on ``device``: to a
    CUDA device through the pinned staging buffers (``_stage_chunks``),
    on the CPU as they are. A reversed view goes up in its own order (the
    staging fills its buffers from it); ``PreparedText`` instead uploads
    such a view's forward bytes and packs them backwards."""
    if isinstance(text, torch.Tensor):
        return text.to(device=device, dtype=torch.uint8).contiguous()
    a = as_bytes_array(text)
    device = torch.device(device)
    st = _staging_for(device) if a.shape[0] else None
    if st is None:
        if not a.flags.writeable or a.strides[0] < 0:
            a = a.copy()
        return torch.from_numpy(a).to(device)
    out = torch.empty(a.shape[0], dtype=torch.uint8, device=device)
    with st.lock:
        _stage_chunks([a], np.array([0, a.shape[0]]), out, st)
    return out


def _upload_set(texts, device: torch.device) -> torch.Tensor:
    """The concatenation of the uint8 host arrays ``texts`` -> a contiguous
    1-D uint8 tensor on ``device``: to a CUDA device through the pinned
    staging buffers (``_stage_chunks``, no host array of the whole set),
    on the CPU as one ``np.concatenate``."""
    offs = np.concatenate([[0], np.cumsum([len(t) for t in texts],
                                          dtype=np.int64)])
    device = torch.device(device)
    st = _staging_for(device) if offs[-1] else None
    if st is None:
        # the host fill of a set with no staging: one array
        with spans.span("stage_fill", fill_bytes=int(offs[-1])):
            whole = (np.concatenate(texts) if texts
                     else np.zeros(0, np.uint8))
        return torch.from_numpy(whole.astype(np.uint8, copy=False)).to(device)
    out = torch.empty(int(offs[-1]), dtype=torch.uint8, device=device)
    with st.lock:
        _stage_chunks(list(texts), offs, out, st)
    return out


def pack_backwards(data: torch.Tensor, profile: Profile,
                   gw: int) -> torch.Tensor:
    """(P[+1], gw) int32 planes of the text ``data`` read backwards: the
    text set's pack of a one-text set (starts [0], lens [n], wofs [0,
    ceil(n / 32)]) with ``reverse`` (``batch.pack_set``: its kernel on
    the card, its plain version on the CPU), over the bytes as they are,
    with no reversed copy."""
    from .batch import pack_set  # batch imports this module

    n = data.numel()
    tab = torch.tensor([0, n, 0, cdiv(n, WORD_BITS)], dtype=torch.int64,
                       device=data.device)
    return pack_set(data, tab[0:1], tab[1:2], tab[2:4], gw, profile,
                    reverse=True)


class PreparedText:
    """Device-resident bit-planes of one text, reusable across patterns
    and k, with its window descriptors cached per tile plan and overhang
    steps (the scan kernels read the windows from the planes).

    ``text`` is the text's bytes (host or device); with ``reverse`` the
    text is those bytes read backwards, packed by ``pack_backwards`` from
    the bytes as they are. A reversed view of a host array (a negative
    stride, as ``CachedRev.rev_text`` gives) is packed that way from its
    forward bytes, uploaded in their own order."""

    def __init__(self, profile: Profile, text, device,
                 reverse: bool = False):
        self.profile = profile
        self.device = torch.device(device)
        if isinstance(text, torch.Tensor):
            data = text.to(device=self.device, dtype=torch.uint8).contiguous()
        else:
            a = as_bytes_array(text)
            if a.strides[0] < 0:
                a, reverse = a[::-1], not reverse
            data = _upload(a, self.device)
        self.n = data.numel()
        # a multiple of PLANE_ALIGN_WORDS: the bucket lattice's are
        self.gw = _bucket_words(cdiv(self.n, WORD_BITS) + TAIL_RESERVE_WORDS)
        # the n uploaded bytes as they are: the packs zero words past them
        if reverse:
            self.planes = pack_backwards(data, profile, self.gw)
        else:
            self.planes = pack(
                data, self.n // WORD_BITS, self.n % WORD_BITS,
                profile.planes, profile.eq_mode == "ascii",
                profile.pack_mode, profile.pack_shift, profile.pack_mask,
                tuple(profile.pack_plane_masks), profile.pack_fold_case,
                self.gw,
            )
        self._descs: dict = {}
        self._overlay: tuple | None = None

    def planes_for(self, steps: int) -> torch.Tensor:
        """The planes with an 'N' overlay on the ``steps`` overhang
        positions past the text end (the last overlay stays cached)."""
        if steps == 0:
            return self.planes
        if self._overlay is None or self._overlay[0] != steps:
            self._overlay = (steps, overlay_n_tail(self.planes, self.n,
                                                   self.n + steps))
        return self._overlay[1]

    def windows(self, T: int, W: int, halo: int, steps: int = 0,
                tail_word: int | None = None) -> Windows:
        """The ``tile_windows`` of ``planes_for(steps)`` for one tile plan;
        with ``tail_word``, the last tile's window is instead the NW words
        from that word on (the overhang tail tile). The descriptors of the
        last two plans stay cached (16 bytes a tile)."""
        key = (steps, T, W, halo, tail_word)
        got = self._descs.get(key)
        if got is None:
            got = tile_windows(self.planes_for(steps), T, W, halo)
            if tail_word is not None:
                wstart, wend = got.wstart.clone(), got.wend.clone()
                wstart[T - 1] = tail_word
                wend[T - 1] = min(self.gw, tail_word + got.NW)
                got = replace(got, wstart=wstart, wend=wend)
            while len(self._descs) >= 2:
                self._descs.pop(next(iter(self._descs)))
            self._descs[key] = got
        return got


class _IdCache:
    """Prepared texts keyed by their source's identity and profile, at most
    ``max_items`` of them (reference ``_IdCache``, myers_xla.py:1188-1214):
    one strand's ``PreparedText``, or the pair of both strands
    (``TorchEngine.prepare_strands``), an entry of its own under the
    forward source's key.

    Each entry holds a weakref to its source whose callback drops the entry
    when the source dies: on the card a one-strand entry holds a text's
    planes (0.5 GiB for 1 GiB of DNA, 1.125 GiB of ascii), a two-strand
    entry both strands' planes (1 GiB for 1 GiB of DNA), with overhang an
    'N' overlay copy of each, and the descriptors of up to two tile plans
    a strand (16 bytes a tile, ~8.5 MB at 1 GiB), so only live sources
    may keep one. The key takes the profile's name and case sensitivity,
    which set the packing, and the number of strands.

    Only sources that cannot change are cached: numpy arrays that are
    read-only down to an immutable base (``bytes``, or memory the array
    owns), such as ``np.frombuffer`` over a record's bytes and views of
    it. The reference keys any array, so an array changed in place after a
    search would get the old text's candidates."""

    def __init__(self, max_items: int = 8):
        self.max_items = max_items
        self._items: dict[tuple, tuple[weakref.ref, PreparedText]] = {}
        # the callbacks run on whichever thread drops a source's last
        # reference, possibly inside a method of this cache
        self._lock = threading.RLock()

    @staticmethod
    def _key(profile: Profile, src, strands: int) -> tuple:
        return (id(src), profile.name, getattr(profile, "case_sensitive", None),
                strands)

    def __len__(self) -> int:
        return len(self._items)

    def get(self, profile: Profile, src, strands: int = 1):
        with self._lock:
            got = self._items.get(self._key(profile, src, strands))
        if got is None or got[0]() is not src:
            return None
        return got[1]

    @staticmethod
    def frozen(src) -> bool:
        """Whether ``src`` is a numpy array that cannot change: no array on
        its chain of bases is writeable, and the last base is ``bytes`` or
        none (the array owns its memory)."""
        if not isinstance(src, np.ndarray):
            return False
        while isinstance(src, np.ndarray):
            if src.flags.writeable:
                return False
            src = src.base
        return src is None or isinstance(src, bytes)

    def put(self, profile: Profile, src, prep, strands: int = 1) -> None:
        if not self.frozen(src):
            return
        key = self._key(profile, src, strands)
        cache = weakref.ref(self)  # an entry must not keep its cache alive

        def drop(ref):
            me = cache()
            if me is None:
                return
            with me._lock:
                if me._items.get(key, (None,))[0] is ref:
                    del me._items[key]

        ref = weakref.ref(src, drop)
        with self._lock:
            while len(self._items) >= self.max_items:
                self._items.pop(next(iter(self._items)))
            self._items[key] = (ref, prep)


@dataclass
class ScanInputs:
    """Everything one scan + selection needs, on the engine's device."""

    windows: Windows  # the tiles' windows in the planes, (NW, P, T)
    tile0: torch.Tensor  # (T,) bool: the tile starts from the true boundary
    text_start: torch.Tensor  # (T,) bool: the tile owns the text start
    valid_from: torch.Tensor  # (T,) int32 window-local, -1 = owns position 0
    valid_to: torch.Tensor  # (T,) int32 window-local last owned position
    islast: torch.Tensor  # (T,) int32 window-local last position, -1 = none
    pmasks: torch.Tensor  # (M, P) int32
    is_pad: torch.Tensor  # (M,) int32
    h_init: torch.Tensor  # (M,) int32
    m_real: int
    boundary_m: int
    k: int
    eq_mode: str  # "iupac", "pure" or "ascii"
    all_minima: bool
    # overhang: the word-level path's strip and tail tile, or the
    # position-level path (fast False) over the plain tiles
    fast: bool = True
    alpha: float | None = None
    n_prev: int = 0
    text_end: torch.Tensor | None = None  # (T,) int64 window-local text end
    n_text: int = 0
    max_pos: int = 0
    W: int = 0
    halo: int = 0
    hier_s: int = 0  # rows of the suffix prefilter; 0 = off

    @property
    def offset(self) -> torch.Tensor:
        """(T,) int64 absolute position of window position 0: 32 times the
        tile's first plane word."""
        return self.windows.wstart * WORD_BITS


class TorchEngine:
    """Single-pattern engine: device pack, window descriptors, scan kernel
    and selection, then one host copy of the candidate list. On a CUDA device
    the scan is the hand-written kernel (and "cuda" without one raises);
    on the CPU, its plain version."""

    name = "torch"

    def __init__(self, device="cuda"):
        self.device = engine_device(device, "TorchEngine")
        self._prep_cache = _IdCache()

    def prepare(self, profile: Profile, text) -> PreparedText:
        """The text's ``PreparedText``, reused while the same read-only
        source array lives (``_IdCache``: its own entry, or the forward
        strand of a two-strand one)."""
        prep = self._prep_cache.get(profile, text)
        if prep is None:
            pair = self._prep_cache.get(profile, text, strands=2)
            if pair is not None:
                return pair[0]
            prep = PreparedText(profile, text, self.device)
            self._prep_cache.put(profile, text, prep)
        return prep

    def prepare_strands(self, profile: Profile,
                        text) -> tuple[PreparedText, PreparedText]:
        """The ``PreparedText`` of the text and of the text read backwards
        (the reverse strand's), from one upload of its bytes: the forward
        planes by the pack kernel, the reverse ones by the text set's pack
        kernel over the same device bytes (``pack_backwards``), which go
        when both are packed. The pair is reused while the same read-only
        source array lives (one ``_IdCache`` entry)."""
        pair = self._prep_cache.get(profile, text, strands=2)
        if pair is None:
            data = _upload(text, self.device)
            pair = (PreparedText(profile, data, self.device),
                    PreparedText(profile, data, self.device, reverse=True))
            self._prep_cache.put(profile, text, pair, strands=2)
        return pair

    def build_inputs(self, profile: Profile, pattern_codes: np.ndarray, text,
                     k: int, alpha=None, max_overhang=None,
                     all_minima: bool = False) -> ScanInputs:
        """The tile plan and inputs of one search (reference
        ``XlaEngine.build_inputs``, myers_xla.py:1251-1364, on the H100
        tile plan). With overhang, positions run to ``n + steps``; an
        overshoot span of at most three words (``n_prev <= 4``) takes the
        word-level path with one extra tail tile, a longer one the
        position-level path. Without overhang, ``hier_s`` > 0 asks for
        the suffix prefilter (reference gate: myers_xla.py:1350-1354)."""
        prep = (text if isinstance(text, PreparedText)
                else self.prepare(profile, text))
        m = len(pattern_codes)
        n = prep.n
        steps = semantics.overhang_steps(m, k, alpha, max_overhang)
        if steps > TAIL_RESERVE_WORDS * WORD_BITS:
            raise ValueError(
                f"overhang of {steps} exceeds supported maximum "
                f"{TAIL_RESERVE_WORDS * WORD_BITS}"
            )
        max_pos = n + steps
        if max_pos >= (1 << 31) - 1:
            raise ValueError(
                f"text of {n} positions exceeds the single-pattern "
                "engine's int32 position space"
            )
        M = _bucket_rows(m)
        words_needed = max(1, cdiv(max_pos, WORD_BITS))
        T, W, halo = plan_tiles(words_needed, halo_words(M, k))
        n_prev = cdiv(steps, WORD_BITS) + 1 if alpha is not None else 0
        fast = n_prev <= 4
        tail_word = None
        if alpha is not None and fast and steps > 0:
            # the tail tile restarts from the plain cost-j boundary, so it
            # re-scans the m + k chars before its owned overshoot span; with
            # no overshoot there is nothing for it to own, and the body
            # tiles keep the text's last position
            W = max(W, cdiv(steps, WORD_BITS) + 1)
            T += 1
            rescan = max(halo * WORD_BITS, M + k)
            tail_word = min(max((n - rescan) // WORD_BITS, 0), prep.gw)
        pmasks, is_pad, h_init, boundary_m = pattern_inputs_np(
            profile, pattern_codes, alpha, max_overhang
        )
        eq_mode = profile.eq_mode
        if eq_mode == "iupac" and _masks_pure_np(pmasks, is_pad):
            # ACGT-pure pattern: one plane per row, on every device
            eq_mode = "pure"

        hier_s = 0
        if alpha is None and profile.eq_mode == "iupac":
            hier_s = plan.suffix_rows(m, k)
            saved = (M - hier_s) * (W + halo + 1) * T
            if not 0 < hier_s < M or saved < plan.HIER_MIN_SAVED_PAIRS:
                hier_s = 0

        dev = self.device
        WB = WORD_BITS
        win = prep.windows(T, W, halo, steps, tail_word)
        tile = torch.arange(T, dtype=torch.int64, device=dev)
        text_start = tile == 0
        offset = win.wstart * WB  # the tail tile's too
        vfrom = torch.where(text_start, -1, halo * WB)
        vto_raw = torch.where(text_start, W * WB, (halo + W) * WB)
        tile0 = text_start
        text_end = None
        if tail_word is None:
            rel_last = max_pos - offset
            vto = torch.minimum(vto_raw, rel_last)
            islast = torch.where(
                (rel_last > vfrom) & (rel_last <= vto_raw), rel_last, -1
            )
        else:
            # body tiles own positions <= n (their meta codes stay
            # raw-exact); tile T-1 owns the overshoot span (n, max_pos]
            s0 = tail_word * WB
            tail = tile == T - 1
            vto = torch.minimum(vto_raw, n - offset)
            islast = torch.full_like(tile, -1)
            tile0 = text_start | (tail & (s0 == 0))
            vfrom = torch.where(tail, n - s0, vfrom)
            vto = torch.where(tail, max_pos - s0, vto)
            islast = torch.where(tail, max_pos - s0, islast)
            text_end = n - offset
        pm_t, pad_t, hinit_t = state_from_numpy(
            pmasks, is_pad, h_init, device=dev
        )
        return ScanInputs(
            windows=win, tile0=tile0,
            text_start=text_start, valid_from=vfrom.to(torch.int32),
            valid_to=vto.to(torch.int32), islast=islast.to(torch.int32),
            pmasks=pm_t, is_pad=pad_t, h_init=hinit_t,
            m_real=m, boundary_m=boundary_m, k=k, eq_mode=eq_mode,
            all_minima=all_minima, fast=fast, alpha=alpha,
            n_prev=n_prev if tail_word is not None else 0,
            text_end=text_end, n_text=n, max_pos=max_pos, W=W, halo=halo,
            hier_s=hier_s,
        )

    def flagged_tiles(self, inp: ScanInputs) -> torch.Tensor:
        """The suffix prefilter (reference myers_xla.py:779-793): the ids
        of the tiles where the pattern's last ``hier_s`` rows alone reach
        a cost <= k at an owned position, from q1meta's screen bit. Exact:
        a row suffix never costs more than the whole pattern at the same
        end. Every tile scans from the plain boundary (no text-start
        state, no pad rows)."""
        S = inp.hier_s
        T = inp.windows.shape[2]
        dev = inp.windows.device
        zeros = torch.zeros(S, dtype=torch.int32, device=dev)
        meta = myers_cuda.scan_meta(
            inp.windows, torch.zeros(T, dtype=torch.bool, device=dev),
            inp.valid_from, inp.valid_to, inp.pmasks[-S:].contiguous(), zeros,
            torch.ones_like(zeros), S, S, inp.k, inp.eq_mode,
        )[3]
        return torch.nonzero(((meta & 1) != 0).any(dim=0)).view(-1)

    @staticmethod
    def gather_tiles(inp: ScanInputs, ids: torch.Tensor) -> ScanInputs:
        """The inputs of the tiles ``ids`` alone, in order, prefilter off.
        The state chain then runs over these tiles as neighbours: every
        owned position of a tile left out costs > k, so no plateau of
        candidates reaches across it (reference myers_xla.py:821-830)."""
        return replace(
            inp, windows=inp.windows.take(ids),
            tile0=inp.tile0[ids], text_start=inp.text_start[ids],
            valid_from=inp.valid_from[ids], valid_to=inp.valid_to[ids],
            islast=inp.islast[ids], hier_s=0,
        )

    def scan(self, inp: ScanInputs):
        """Word level: (vp, vm, cost, meta) each (NW, T) and final (T,),
        int32, from q1meta. Position level: (vp, vm, cost) from q1."""
        if not inp.fast:
            return myers_cuda.scan(
                inp.windows, inp.tile0, inp.pmasks, inp.is_pad, inp.h_init,
                inp.m_real, inp.boundary_m, inp.eq_mode,
            )
        return myers_cuda.scan_meta(
            inp.windows, inp.tile0, inp.valid_from, inp.valid_to, inp.pmasks,
            inp.is_pad, inp.h_init, inp.m_real, inp.boundary_m, inp.k,
            inp.eq_mode,
        )

    def select(self, inp: ScanInputs, outs) -> torch.Tensor:
        """(2, N) int64 [end positions; costs] on the device."""
        if not inp.fast:
            vp, vm, cost = outs
            return minima.select_candidates(
                vp, vm, cost, inp.W, inp.halo, inp.boundary_m, inp.n_text,
                inp.max_pos, inp.k, inp.alpha, inp.all_minima,
            )
        # the chain resets at the text start only: the tail tile's window
        # may start at the boundary, but the text does not restart there
        cols, _ = minima.select_words_chained(
            *(o[None] for o in outs), inp.text_start, None, inp.valid_from,
            inp.valid_to, inp.islast, inp.offset, inp.k, inp.all_minima,
            inp.text_end, inp.alpha, inp.n_prev,
        )
        return cols[2:]

    def candidates(self, profile: Profile, pattern_codes: np.ndarray, text,
                   k: int, alpha, max_overhang, all_minima: bool):
        """Sorted [(end position, cost)] of one pattern on one strand."""
        return self.candidates_async(profile, pattern_codes, text, k, alpha,
                                     max_overhang, all_minima)()

    def candidates_async(self, profile: Profile, pattern_codes: np.ndarray,
                         text, k: int, alpha, max_overhang,
                         all_minima: bool):
        """Start one search on the dispatch thread and return a
        ``finish()`` that waits for its sorted [(end position, cost)]
        (reference myers_xla.py:1381-1526). The thread prepares the text,
        builds the inputs, runs the suffix prefilter, the scan and the
        selection, and makes the one host copy; dispatching the next search
        before finishing this one overlaps them. Errors of the dispatch are
        raised by ``finish()``."""

        def run():
            inp = self.build_inputs(profile, pattern_codes, text, k, alpha,
                                    max_overhang, all_minima)
            if inp.hier_s:
                ids = self.flagged_tiles(inp)
                if ids.numel() == 0:
                    return []
                inp = self.gather_tiles(inp, ids)
            pos, cost = self.select(inp, self.scan(inp)).cpu().tolist()
            return sorted(zip(pos, cost))

        return dispatch_async(self.device, run).result
