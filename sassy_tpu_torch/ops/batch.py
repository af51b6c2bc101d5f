"""The batched multi-pattern engine in PyTorch: Q patterns x N texts.

Port of ``sassy_tpu/ops/batch.py``. Texts are cut into pieces (whole short
texts, or word-aligned, halo-overlapped segments of long ones:
``_plan_pieces``, cut as columns by ``_plan_columns``); the pieces of all
texts form the tile axis of one scan, at a width (``_piece_width``) that
lets a full dispatch chunk fill the card.
The texts' bytes are uploaded once, concatenated (through the pinned
staging of ``myers_torch._upload_set``, filled from the texts' own arrays:
no host buffer of the set), and each strand's bit-planes are one launch of
the text set's pack kernel over them (``pack_set``: the reverse strand
reads each text backwards; with overhang each text is followed by its 'N'
overshoot positions); the scan
kernels read each piece's window, NW = W + 1 words (one word of right
context past the owned range), straight from those planes through the
piece's descriptor (``TextSet.descriptor``: its first plane word and the
end of its text's words), so no dispatch gathers windows.

Patterns are grouped by row bucket and overhang steps. A group whose
overshoot spans at most three words (always, without overhang) takes the
word-level path: the q2meta kernel (``myers_cuda.scan_q_meta``) and
``minima.select_words_chained`` (the cross-piece state chain inside the
selection). A longer
overshoot takes the position-level path: the q2 kernel
(``myers_cuda.scan_q``) and ``minima.select_candidates_tiles``, which
expands every (pattern, position): one scan launch per dispatch chunk, its
selection in tile sub-ranges of at most ``minima.POSITIONS_PER_CHUNK``
expanded pairs (the state carried across them as across chunks). Either
way the candidates leave the device as (pattern, text, end position,
cost) columns in one copy.

Without overhang, a group whose shortest pattern has
``plan.suffix_rows`` > 0 runs the hierarchical suffix prefilter on every
dispatch chunk where the suffix scan saves at least
``plan.HIER_MIN_SAVED_PAIRS`` (row, word) pairs: q2meta
with each pattern's last rows flags the pieces that can hold a match of
any pattern, and the full scan and selection run on those pieces only.

``candidates_many_async`` hands that device work to the dispatch thread
it shares with the single engine (``myers_torch.dispatch_async``) and
returns at once: each chunk's ``torch.nonzero`` makes the host wait
for the chunk's scan, and on the caller's thread that wait would hold up
whatever the caller does next (the reverse strand's dispatch, the previous
record batch's traceback). ``finish()`` waits for the thread's copy and
decodes it on the caller's thread.

Results equal the single-pattern engine's per (pattern, text), however the
work is chunked: the decreasing-state chain is carried from one tile chunk
into the next (the JAX package truncates it to state 0 at chunk edges,
``sassy_tpu/ops/batch.py:672-676``).

``_Piece``, ``_plan_pieces``, ``_w_lattice`` and ``_pick_w_words``
reproduce the numpy planner of the JAX package without its TPU
``pad_mult`` (that module imports the JAX engines, this package must not);
the tests hold them equal to the originals.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .. import semantics, spans
from ..profiles import Profile, as_bytes_array
from . import minima, myers_cuda, plan
from .bitpack import WORD_BITS
from .minima import FULL, i32
from .myers_torch import (Windows, _upload_set, aligned_words,
                          dispatch_async, engine_device, pack_plain,
                          state_from_numpy)
from .plan import _bucket_words, _masks_pure_np, cdiv, pattern_inputs_np

__all__ = ["BatchEngine", "TextSet", "pack_set", "pack_set_plain",
           "DISPATCH_BYTES", "W_MAX_WORDS"]

#: Kernel output bytes one dispatch may write (vp, vm, cost and, at the
#: word level, meta: 12 or 16 bytes per pattern and window word): 4 GiB of
#: the H100's 80 GB, so the selection's temporaries and both strands'
#: planes fit beside it.
DISPATCH_BYTES = 4 << 30

#: Widest piece window in words (the JAX package's ``w_max_words``).
W_MAX_WORDS = 1 << 13

#: Plane words ``pack_set_plain`` lays out and packs per pass: 16 MiB of
#: positions, each with int64 indices (128 MiB a tensor).
SET_CHUNK_WORDS = 1 << 19

@dataclass
class _Piece:
    """One tile of the batched scan: a text, or a halo-prefixed segment."""

    text_idx: int
    start_char: int  # text-local char index at piece position 0
    valid_from: int  # positions > valid_from are owned (-1: owns position 0)
    valid_to: int  # positions <= valid_to are owned
    text_end: int  # piece-local position of the text end (overshoot anchor)
    islast_at: int  # trailing-minimum position (-1 for non-final segments)
    true_start: bool


def _plan_pieces(lens: list[int], steps: int, w_chars: int,
                 halo: int) -> list[_Piece]:
    """Cut texts into pieces of <= w_chars positions each.

    Position space of text t is 1..n_t + steps (+ the boundary position 0,
    owned by the true-start piece). A continuation piece re-scans ``halo``
    chars before its owned range, from a word-aligned start.
    """
    pieces: list[_Piece] = []
    for t, n in enumerate(lens):
        total = n + steps
        o = 0  # first not-yet-owned position
        first = True
        while True:
            if first:
                own = min(total, w_chars)
                start_char = 0
                vfrom = -1
            else:
                # word-aligned window start: piece windows are word slices
                # of the packed text; the halo grows by up to 31 chars
                start_char = (o - halo) // WORD_BITS * WORD_BITS
                vfrom = o - start_char
                own = min(total - o, w_chars - vfrom)
            if steps and o < n and n < o + own < total:
                # never split the overshoot span (n, n + steps] across
                # pieces: the word-level overhang path derives the final
                # piece's cross-piece state from RAW delta codes, exact only
                # while all prior pieces own raw (<= n) positions
                own = n - o
            last = o + own >= total
            pieces.append(
                _Piece(
                    text_idx=t,
                    start_char=start_char,
                    valid_from=vfrom,
                    valid_to=vfrom + own if not first else own,
                    text_end=n - start_char,
                    islast_at=(vfrom if not first else 0) + own if last else -1,
                    true_start=first,
                )
            )
            o += own
            first = False
            if last:
                break
    return pieces


#: ``_Piece``'s fields, the columns of ``_plan_columns``
PIECE_FIELDS = tuple(f.name for f in fields(_Piece))


def _plan_columns(lens: list[int], steps: int, w_chars: int,
                  halo: int) -> dict[str, np.ndarray]:
    """``_plan_pieces``' pieces as int64 columns, one per ``_Piece``
    field, cut without an object per piece or a loop per text: every text
    that fits one piece at once, and all longer texts in lockstep, their
    loop state (the first not-yet-owned position ``o``) a vector. Each
    step takes, for every text whose ``o`` is word-aligned, its whole run
    of regular continuation pieces (a start ``hw`` chars before the
    piece's first owned position, ``hw`` the halo rounded up to words,
    ``w_chars - hw`` owned positions) until one would reach the overshoot
    split (positions up to n) or the text end, then cuts one piece of
    every text as the loop does (the first, the one ending at the split,
    one from an unaligned ``o``, the last). A text takes a few steps
    whatever the number of texts. The pieces are then put in the loop's
    order: text-major, by first owned position. Equal to ``_plan_pieces``
    (the tests hold both to the JAX planner)."""
    n_all = np.asarray(lens, np.int64).reshape(-1)
    total_all = n_all + steps
    hw = cdiv(halo, WORD_BITS) * WORD_BITS
    stride = w_chars - hw
    cols: dict[str, list] = {f: [] for f in PIECE_FIELDS}

    def put(t, start, vfrom, vto, islast, first) -> None:
        start = np.broadcast_to(start, t.shape)
        for f, v in (("text_idx", t), ("start_char", start),
                     ("valid_from", vfrom), ("valid_to", vto),
                     ("text_end", n_all[t] - start), ("islast_at", islast),
                     ("true_start", first)):
            cols[f].append(np.broadcast_to(np.asarray(v, np.int64),
                                           t.shape))

    one = np.nonzero(total_all <= w_chars)[0]
    own = total_all[one]
    put(one, 0, -1, own, own, 1)
    t = np.nonzero(total_all > w_chars)[0]
    n, total = n_all[t], total_all[t]
    # the first piece of every long text
    own = np.full(t.shape, w_chars, np.int64)
    if steps:
        split = (0 < n) & (n < own)  # own < total: the text is long
        own[split] = n[split]
    put(t, 0, -1, own, -1, 1)
    o = own
    while t.size:
        if stride > 0 and stride % WORD_BITS == 0:
            # from a word-aligned o, each piece owns ``stride`` positions
            lim = np.where(o < n, n, total - 1) if steps else total - 1
            runs = np.where(o % WORD_BITS == 0,
                            np.maximum(0, (lim - o - stride) // stride + 1),
                            0)
            if runs.any():
                first_of = np.cumsum(runs) - runs
                i = np.arange(int(first_of[-1] + runs[-1]), dtype=np.int64)
                at = (np.repeat(o, runs)
                      + stride * (i - np.repeat(first_of, runs)))
                put(np.repeat(t, runs), at - hw, hw, w_chars, -1, 0)
                o = o + runs * stride
        start = (o - halo) // WORD_BITS * WORD_BITS
        vfrom = o - start
        own = np.minimum(total - o, w_chars - vfrom)
        if steps:
            # never split the overshoot span (see _plan_pieces)
            split = (o < n) & (n < o + own) & (o + own < total)
            own = np.where(split, n - o, own)
        last = o + own >= total
        put(t, start, vfrom, vfrom + own, np.where(last, vfrom + own, -1), 0)
        o = o + own
        more = ~last
        t, n, total, o = t[more], n[more], total[more], o[more]
    got = {f: np.concatenate(v) for f, v in cols.items()}
    if len(one) < len(n_all):
        order = np.argsort(got["text_idx"], kind="stable")
        got = {f: v[order] for f, v in got.items()}
    return got


def _w_lattice(cap: int) -> list[int]:
    """The shape-bucket lattice {4,5,6,7} * 2^j (>= 16) up to ``cap``."""
    vals = [16]
    p = 16
    while p < cap:
        for f in (20, 24, 28, 32):
            v = p * f // 16
            if v <= cap:
                vals.append(v)
        p *= 2
    return sorted(set(vals))


def _pick_w_words(lens: list[int], steps: int, halo: int, w_cap: int) -> int:
    """Piece-window width (words) minimizing total scanned words.

    The kernel scans every piece's full window, so a width that divides the
    text lengths poorly pads each text by up to w_chars - 1 chars. Evaluate
    the bucket lattice <= w_cap with an analytic piece-count model; ties
    prefer the widest window (fewest pieces)."""
    cands = _w_lattice(w_cap)
    if w_cap not in cands:
        cands.append(w_cap)
    ln = np.asarray(lens, np.int64) + steps
    halo_a = halo + WORD_BITS - 1  # worst-case word-aligned halo re-scan
    best_w, best_cost = None, None
    for w in cands:
        wc = w * WORD_BITS
        if wc <= halo + WORD_BITS or wc <= halo_a + WORD_BITS:
            continue
        over = np.maximum(ln - wc, 0)
        cont = -(-over // (wc - halo_a))
        cost = int(np.sum(1 + cont + ((steps > 0) & (over > 0)))) * w
        if best_cost is None or cost < best_cost or (
            cost == best_cost and w > best_w
        ):
            best_w, best_cost = w, cost
    return best_w if best_w is not None else w_cap


def _piece_width(lens: list[int], steps: int, halo: int,
                 n_patterns: int, pair_bytes: int) -> int:
    """Piece width in chars for one group: small enough that the pieces
    times the patterns fill the card (one thread per pair, the single
    path's ``plan.H100_TARGET_TILES``), wide enough to amortize the halo
    re-scan (>= 4 halos), at most the longest text with its overshoot.

    A dispatch chunk holds ``DISPATCH_BYTES // (pair_bytes * NW)`` pairs
    (``BatchEngine.chunks``), so the window is also kept narrow enough
    that a full chunk launches ``plan.H100_TARGET_TILES`` threads or more,
    unless that would cut pieces below four halos: many patterns over a
    long text otherwise reach ``W_MAX_WORDS`` and launch a small fraction
    of the card (312 guides over 3.12 Gbp: 105 pieces a launch, 32,760
    threads)."""
    tiles = cdiv(plan.H100_TARGET_TILES, n_patterns)
    target = max(4 * halo, cdiv(sum(lens) + steps * len(lens), tiles),
                 4 * WORD_BITS)
    fill = DISPATCH_BYTES // (pair_bytes * plan.H100_TARGET_TILES) - 1
    w_cap = min(
        _bucket_words(max(cdiv(max(lens) + steps, WORD_BITS), 1)),
        _bucket_words(cdiv(target, WORD_BITS)),
        W_MAX_WORDS,
        max(_w_lattice(fill)[-1], _bucket_words(cdiv(4 * halo, WORD_BITS))),
    )
    w_chars = _pick_w_words(lens, steps, halo, w_cap) * WORD_BITS
    if w_chars <= halo + WORD_BITS:
        w_chars = _bucket_words(cdiv(halo + 4 * WORD_BITS, WORD_BITS)) * WORD_BITS
    return w_chars


@dataclass
class PiecePlan:
    """The pieces of one (halo, piece width, overhang steps) as device
    tables, (T,) each."""

    w_chars: int
    steps: int
    true_start: torch.Tensor  # bool
    valid_from: torch.Tensor  # int32, piece-local
    valid_to: torch.Tensor  # int32
    islast_at: torch.Tensor  # int32
    text_end: torch.Tensor  # int64, piece-local text end
    start_char: torch.Tensor  # int64, text-local position of piece position 0
    text_idx: torch.Tensor  # int64
    wstart: torch.Tensor  # int64, flat plane word of the piece start
    wend: torch.Tensor  # int64, the end of its text's plane words

    @property
    def T(self) -> int:
        return self.true_start.shape[0]

    def take(self, ids: torch.Tensor) -> "PiecePlan":
        """The plan of the pieces ``ids`` alone, in that order."""
        return PiecePlan(**{
            f.name: (v[ids] if isinstance(v, torch.Tensor) else v)
            for f in fields(self) for v in (getattr(self, f.name),)
        })

    @property
    def NW(self) -> int:
        return self.w_chars // WORD_BITS + 1


def _bits_below(x: torch.Tensor) -> torch.Tensor:
    """Each word's bits below its position x (int64, x clamped to 0..32)."""
    b = x.clamp(0, WORD_BITS)
    return torch.where(b >= WORD_BITS, FULL, (1 << b) - 1)


def pack_set(data, starts, lens, wofs, width: int, profile: Profile,
             reverse: bool = False, steps: int = 0) -> torch.Tensor:
    """A text set's (P[+1], width) int32 bit-planes (``pack_set_plain``
    says what they hold): ``pack_set_plain`` for bytes on the CPU, the
    text set's pack kernel (``myers_cuda.pack_set``, ``csrc/pack.cu``) for
    bytes on a CUDA device, which raises on inputs it does not take; no
    fallback."""
    if data.device.type == "cpu":
        return pack_set_plain(data, starts, lens, wofs, width, profile,
                              reverse, steps)
    return myers_cuda.pack_set(data, starts, lens, wofs, width, profile,
                               reverse, steps)


def pack_set_plain(data, starts, lens, wofs, width: int, profile: Profile,
                   reverse: bool = False, steps: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the text set's pack kernel. data (L,)
    uint8, the texts' bytes; starts, lens (T,) int64, text t's first byte
    and length n_t; wofs (T + 1,) int64, its first plane word and the
    total. Returns (P[+1], width) int32 (the words below width): text t's
    words from wofs[t], its position i the byte ``starts[t] + i`` (with
    ``reverse``, ``starts[t] + n_t - 1 - i``) packed as
    ``myers_torch.pack_plain`` packs, every plane bit set at its ``steps``
    positions past n_t ('N', the overhang's pad), zero past them and from
    word wofs[T] on; the validity plane (ascii) marks positions < n_t +
    steps. Per pass of ``SET_CHUNK_WORDS`` words: the bytes laid out in
    their words by one gather, ``pack_plain``, then each word's n_t and
    'N' masks."""
    pack_set_plain.calls += 1
    if steps and not profile.supports_overhang:
        raise ValueError(f"{steps} overhang steps on the {profile.name} "
                         f"profile, which has no overhang")
    dev = data.device
    words = min(int(wofs[-1]), width)
    with_valid = profile.eq_mode == "ascii"
    out = torch.zeros((profile.planes + int(with_valid), width),
                      dtype=torch.int32, device=dev)
    for w0 in range(0, words, SET_CHUNK_WORDS):
        w1 = min(words, w0 + SET_CHUNK_WORDS)
        w = torch.arange(w0, w1, dtype=torch.int64, device=dev)
        t = torch.searchsorted(wofs, w, right=True) - 1
        # each word's position 0 against its text's n_t
        rest = lens[t] - WORD_BITS * (w - wofs[t])
        # the words' bytes, forwards or backwards, zero past n_t
        i = torch.arange(WORD_BITS, device=dev)[None, :]
        inside = i < rest[:, None]
        at = lens[t][:, None] - rest[:, None] + i  # text-local byte
        if reverse:
            at = lens[t][:, None] - 1 - at
        src = (starts[t][:, None] + at).clamp(0, max(data.numel() - 1, 0))
        buf = (torch.where(inside, data[src], 0) if data.numel()
               else torch.zeros_like(src, dtype=torch.uint8))
        got = pack_plain(buf.reshape(-1).to(torch.uint8), w1 - w0, 0,
                         profile.planes, with_valid, profile.pack_mode,
                         profile.pack_shift, profile.pack_mask,
                         tuple(profile.pack_plane_masks),
                         profile.pack_fold_case)
        keep = _bits_below(rest)
        out[:, w0:w1] = (got & i32(keep)) | i32(_bits_below(rest + steps)
                                                ^ keep)
    return out


pack_set_plain.calls = 0


class TextSet:
    """A batch of texts on one device: piece plans per (halo, piece width,
    overhang steps) and bit-planes per (profile, strand, steps), reusable
    across patterns and k.

    On the device the texts' bytes lie in one buffer, concatenated (text t
    from byte ``offs[t]``, each byte once, no gaps), uploaded once
    (``myers_torch._upload_set``: staged from the texts' own arrays, with
    no host array of the set). The planes of a strand are one flat (P, L)
    array: text t owns words [wofs[t], wofs[t] + ceil((n_t + steps) /
    32)), 'N' (every plane bit set) at its ``steps`` overshoot positions
    and zero past them; the words from GW on are all-zero, L = GW + 1
    rounded up to a multiple of ``myers_torch.PLANE_ALIGN_WORDS`` (the rows
    the scan kernels read). They are one ``pack_set`` over the bytes and
    the tables of ``tables(steps)``: on the card one launch of the text
    set's pack kernel, forwards or backwards, with or without the
    overshoot. A piece reads zero past its text's words (its descriptor's
    ``wend``). "cuda" without a CUDA device raises."""

    def __init__(self, texts, device="cuda"):
        self.texts = [as_bytes_array(t) for t in texts]
        self.lens = [len(t) for t in self.texts]
        self.device = engine_device(device, "TextSet")
        n = np.asarray(self.lens, np.int64)
        self._nw = -(-n // WORD_BITS)
        self._wofs = np.concatenate([[0], np.cumsum(self._nw)]).astype(np.int64)
        self._offs = np.concatenate([[0], np.cumsum(n)]).astype(np.int64)
        #: bytes of all texts
        self.nbytes = int(self._offs[-1])
        self._plans: dict = {}
        self._planes: dict = {}
        self._tables: dict = {}
        self._data = None

    def layout(self, steps: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """(words per text, first word per text + the total) of the planes
        with ``steps`` overshoot positions per text."""
        if steps == 0:
            return self._nw, self._wofs
        nw = -(-(np.asarray(self.lens, np.int64) + steps) // WORD_BITS)
        return nw, np.concatenate([[0], np.cumsum(nw)]).astype(np.int64)

    def words(self, steps: int = 0) -> int:
        """Plane words of all texts, the zero word excluded."""
        return int(self.layout(steps)[1][-1])

    def piece_plan(self, halo: int, w_chars: int, steps: int = 0) -> PiecePlan:
        key = (halo, w_chars, steps)
        got = self._plans.get(key)
        if got is None:
            with spans.span("plan"):
                got = self._plan(halo, w_chars, steps)
            spans.count(pieces=got.T)
            self._plans[key] = got
        return got

    def _plan(self, halo: int, w_chars: int, steps: int) -> PiecePlan:
        col = _plan_columns(self.lens, steps, w_chars, halo).get
        tidx = col("text_idx")
        wstart = col("start_char") // WORD_BITS
        nw, wofs = self.layout(steps)
        i32 = lambda a: a.astype(np.int32)  # noqa: E731
        cols = dict(
            true_start=col("true_start") != 0,
            valid_from=i32(col("valid_from")),
            valid_to=i32(col("valid_to")),
            islast_at=i32(col("islast_at")),
            text_end=col("text_end"),
            start_char=col("start_char"),
            text_idx=tidx,
            wstart=wofs[tidx] + wstart,
            wend=wofs[tidx] + nw[tidx],
        )
        # PyTorch synchronises a copy from pageable memory with the stream:
        # on the card it waits for the work queued before it
        with spans.span("device_wait", device_waits=1):
            return PiecePlan(w_chars=w_chars, steps=steps, **{
                name: torch.from_numpy(a).to(self.device)
                for name, a in cols.items()})

    def data(self) -> torch.Tensor:
        """The texts' bytes on the device, concatenated (uploaded at the
        first call)."""
        if self._data is None:
            with spans.span("upload"):
                self._data = _upload_set(self.texts, self.device)
        return self._data

    def tables(self, steps: int = 0) -> tuple[torch.Tensor, ...]:
        """(starts, lens, wofs) int64 on the device, ``pack_set``'s tables:
        each text's first byte in ``data()``, its length, and its first
        plane word with ``steps`` overshoot positions a text (and the
        total)."""
        got = self._tables.get(steps)
        if got is None:
            # PyTorch synchronises each copy with the stream: on the card
            # they wait for the upload's last chunk
            with spans.span("device_wait", device_waits=1):
                got = self._tables[steps] = tuple(
                    torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                    for a in (self._offs[:-1], np.diff(self._offs),
                              self.layout(steps)[1]))
        return got

    def planes(self, profile: Profile, reverse: bool,
               steps: int = 0) -> torch.Tensor:
        """(P[+1], GW + 1) int32 bit-planes of the (reversed) texts, each
        followed by ``steps`` 'N' positions: one ``pack_set``, cached."""
        key = (profile.name, getattr(profile, "case_sensitive", None), reverse,
               steps)
        got = self._planes.get(key)
        if got is None:
            data = self.data()
            with spans.span("pack"):
                got = pack_set(data, *self.tables(steps),
                               aligned_words(self.words(steps) + 1), profile,
                               reverse, steps)
            self._planes[key] = got
        return got

    def strand_planes(self, profile: Profile,
                      reverse: bool) -> tuple[torch.Tensor, np.ndarray]:
        """The planes of a strand as the host finish's traceback reads
        them, and each text's first word in them: those already packed
        with the fewest overhang steps (a text's positions read the same
        whatever the steps past it), else ``planes(profile, reverse)``."""
        key = (profile.name, getattr(profile, "case_sensitive", None),
               reverse)
        steps = sorted(k[3] for k in self._planes if k[:3] == key)
        steps = steps[0] if steps else 0
        return (self.planes(profile, reverse, steps),
                self.layout(steps)[1][:-1])

    def descriptor(self, profile: Profile, pp: PiecePlan, reverse: bool,
                   t0: int, t1: int) -> Windows:
        """The windows of pieces t0..t1 as the scan kernels read them: each
        piece's NW words from its start in the strand's planes, zero past
        its text's words."""
        return Windows(self.planes(profile, reverse, pp.steps),
                       pp.wstart[t0:t1], pp.wend[t0:t1], pp.NW)

    def windows(self, profile: Profile, pp: PiecePlan, reverse: bool,
                t0: int, t1: int) -> torch.Tensor:
        """(NW, P, t1 - t0) int32 windows of pieces t0..t1, gathered from
        their ``descriptor`` (``myers_torch.windows_plain``): piece words
        [start, start + NW) of its text, zero past the text end. For the
        tests and the kernel-design tools; no search path gathers."""
        return self.descriptor(profile, pp, reverse, t0, t1).gather()


@dataclass
class _Group:
    """The patterns of one row bucket M: one scan shape."""

    qidx: torch.Tensor  # (Qg,) int64 pattern indices of the call
    pmasks: torch.Tensor  # (Qg, M, PM) int32
    is_pad: torch.Tensor  # (Qg, M) int32
    h_init: torch.Tensor  # (Qg, M) int32
    m_real: torch.Tensor  # (Qg,) int32
    boundary_m: torch.Tensor  # (Qg,) int32
    eq_mode: str  # "iupac", "pure" or "ascii"
    halo: int  # chars of left context a continuation piece re-scans
    w_chars: int  # piece width
    steps: int = 0  # overhang positions past each text end
    alpha: float | None = None
    n_prev: int = 0  # overshoot strip words of the word-level path
    hier_s: int = 0  # rows of the suffix prefilter; 0 = off

    @property
    def Q(self) -> int:
        return self.qidx.shape[0]

    @property
    def fast(self) -> bool:
        """The word-level path: no overhang, or an overshoot span of at
        most three words; the position-level path otherwise."""
        return self.n_prev <= 4

    @property
    def pair_bytes(self) -> int:
        """Kernel output bytes per (pattern, window word): vp, vm, cost
        and, on the word-level path, meta."""
        return 16 if self.fast else 12


class BatchEngine:
    """Cartesian-product candidate engine: Q patterns x N texts, batched.

    ``candidates_many`` returns ``out[q][t] = [(end_pos, cost), ...]`` with
    results identical to the single-(pattern, text) engine. On a CUDA
    device the scans are the q2meta and q2 kernels (and "cuda" without one
    raises); on the CPU, their plain versions.
    """

    def __init__(self, device="cuda"):
        self.device = engine_device(device, "BatchEngine")

    def textset(self, texts) -> TextSet:
        if isinstance(texts, TextSet):
            if texts.device != self.device:
                raise ValueError(f"TextSet on {texts.device}, engine on "
                                 f"{self.device}")
            return texts
        return TextSet(texts, self.device)

    def groups(self, profile: Profile, pattern_codes, ts: TextSet, k: int,
               alpha=None, max_overhang=None) -> list[_Group]:
        """The patterns grouped by row bucket M and overhang steps (one
        piece plan each: patterns of any lengths share a call), with their
        scan inputs on the device and their piece width."""
        per = [pattern_inputs_np(profile, c, alpha, max_overhang)
               for c in pattern_codes]
        by_m: dict[tuple, list[int]] = {}
        for qi, p in enumerate(per):
            steps = semantics.overhang_steps(len(pattern_codes[qi]), k, alpha,
                                             max_overhang)
            by_m.setdefault((p[0].shape[0], steps), []).append(qi)
        out = []
        for (M, steps), qidx in by_m.items():
            eq_mode = profile.eq_mode
            # ACGT-pure patterns load one plane per row; the whole launch
            # must be pure
            if eq_mode == "iupac" and all(
                _masks_pure_np(per[q][0], per[q][1]) for q in qidx
            ):
                eq_mode = "pure"
            state = [np.stack([per[q][i] for q in qidx]) for i in range(3)]
            scal = np.array([[len(pattern_codes[q]) for q in qidx],
                             [per[q][3] for q in qidx]], np.int32)
            # copies from pageable memory, each synchronised with the stream
            with spans.span("device_wait", device_waits=1):
                pm, pad, hi = state_from_numpy(*state, device=self.device)
                scal = torch.from_numpy(scal).to(self.device)
                qi = torch.tensor(qidx, dtype=torch.int64, device=self.device)
            g = _Group(
                qidx=qi,
                pmasks=pm, is_pad=pad, h_init=hi, m_real=scal[0],
                boundary_m=scal[1], eq_mode=eq_mode, halo=M + k, w_chars=0,
                steps=steps, alpha=alpha,
                n_prev=(cdiv(steps, WORD_BITS) + 1 if alpha is not None
                        else 0),
                hier_s=self._hier_rows(
                    min(len(pattern_codes[q]) for q in qidx), M, k, alpha),
            )
            g.w_chars = _piece_width(ts.lens, steps, g.halo, g.Q,
                                     g.pair_bytes)
            out.append(g)
        return out

    @staticmethod
    def _hier_rows(m_min: int, M: int, k: int, alpha) -> int:
        """Rows of the group's suffix prefilter (reference gate:
        batch.py:1046-1050, 623): from the shortest pattern, so that every
        pattern's last rows are real ones; off with overhang."""
        s = plan.suffix_rows(m_min, k) if alpha is None else 0
        return s if s < M else 0

    @staticmethod
    def chunks(g: _Group, pp: PiecePlan):
        """(q0, q1, t0, t1) dispatch chunks, whole patterns first, each
        one kernel launch of at most ``DISPATCH_BYTES`` of outputs. The
        tile chunks of one pattern range come in order, as the state chain
        needs."""
        per_pair = g.pair_bytes * pp.NW
        q_chunk = max(1, min(g.Q, DISPATCH_BYTES // per_pair))
        t_chunk = max(1, DISPATCH_BYTES // (q_chunk * per_pair))
        for q0 in range(0, g.Q, q_chunk):
            for t0 in range(0, pp.T, t_chunk):
                yield q0, min(g.Q, q0 + q_chunk), t0, min(pp.T, t0 + t_chunk)

    @staticmethod
    def select_ranges(g: _Group, pp: PiecePlan, n_q: int, t0: int, t1: int,
                      device):
        """The tile ranges, in order, that the selection of the chunk of
        ``n_q`` patterns over tiles t0..t1 runs over, for scan outputs on
        ``device``: the whole chunk on the word-level path (only screened
        words expand) and on a CUDA device (the kernels keep no
        temporaries); on the CPU, the position level's plain version in
        sub-ranges of at most ``minima.POSITIONS_PER_CHUNK`` expanded
        (pattern, position) pairs, which bound its temporaries."""
        step = t1 - t0
        if not g.fast and torch.device(device).type == "cpu":
            step = max(1, minima.POSITIONS_PER_CHUNK
                       // (n_q * pp.NW * WORD_BITS))
        for s0 in range(t0, t1, step):
            yield s0, min(t1, s0 + step)

    @staticmethod
    def scan(win, g: _Group, pp: PiecePlan, q0, q1, t0, t1, k: int):
        """The kernel over one chunk's windows (``win``, their descriptor:
        ``TextSet.descriptor``): word level, q2meta's (vp, vm, cost, meta)
        each (q1 - q0, NW, t1 - t0) and final (q1 - q0, t1 - t0); position
        level, q2's (vp, vm, cost)."""
        if not g.fast:
            return myers_cuda.scan_q(
                win, pp.true_start[t0:t1], g.pmasks[q0:q1], g.is_pad[q0:q1],
                g.h_init[q0:q1], g.m_real[q0:q1], g.boundary_m[q0:q1],
                g.eq_mode,
            )
        return myers_cuda.scan_q_meta(
            win, pp.true_start[t0:t1], pp.valid_from[t0:t1],
            pp.valid_to[t0:t1], g.pmasks[q0:q1], g.is_pad[q0:q1],
            g.h_init[q0:q1], g.m_real[q0:q1], g.boundary_m[q0:q1], k,
            g.eq_mode,
        )

    @staticmethod
    def flagged_pieces(win, g: _Group, pp: PiecePlan, q0, q1, t0, t1,
                       k: int) -> torch.Tensor:
        """The suffix prefilter over one chunk's windows (reference
        batch.py:623-641): the chunk-local ids of the pieces where the
        last ``g.hier_s`` rows of any pattern q0..q1 alone reach a cost
        <= k at an owned position, from q2meta's screen bit. Exact: a row
        suffix never costs more than the whole pattern at the same end.
        Every piece scans from the plain boundary."""
        S, n_q = g.hier_s, q1 - q0
        dev = win.device
        zeros = torch.zeros((n_q, S), dtype=torch.int32, device=dev)
        s_vec = torch.full((n_q,), S, dtype=torch.int32, device=dev)
        meta = myers_cuda.scan_q_meta(
            win, torch.zeros(t1 - t0, dtype=torch.bool, device=dev),
            pp.valid_from[t0:t1], pp.valid_to[t0:t1],
            g.pmasks[q0:q1, -S:].contiguous(), zeros, torch.ones_like(zeros),
            s_vec, s_vec, k, g.eq_mode,
        )[3]
        flagged = ((meta & 1) != 0).any(dim=1).any(dim=0)
        with spans.span("device_wait", device_waits=1):
            return torch.nonzero(flagged).view(-1)

    @staticmethod
    def select(outs, g: _Group, pp: PiecePlan, q0, t0, t1, k: int,
               all_minima: bool, carry):
        """The candidates of tiles t0..t1 (one of the chunk's
        ``select_ranges``; ``outs`` are the scan's outputs sliced to them)
        as (4, N) int64 device columns [pattern; text; end position; cost],
        and the state code carried into the next tile range. ``carry``
        (Qc, 1) int32: the code after the previous tile range (0 at the
        first)."""
        vf, vt = pp.valid_from[t0:t1], pp.valid_to[t0:t1]
        tend = pp.text_end[t0:t1]
        if not g.fast:
            # the state chain, the previous range's carry entering before
            # this range's first piece, runs inside the selection
            vp, vm, cost = outs
            q1 = q0 + vp.shape[0]
            boundary0 = torch.where(pp.true_start[None, t0:t1],
                                    g.boundary_m[q0:q1, None],
                                    g.m_real[q0:q1, None])
            cols, carry = minima.select_candidates_chained(
                vp, vm, cost, boundary0, tend, vf, vt, pp.islast_at[t0:t1],
                pp.start_char[t0:t1], k, g.alpha, pp.true_start[t0:t1],
                carry, all_minima,
            )
        else:
            cols, carry = minima.select_words_chained(
                *outs, pp.true_start[t0:t1], carry, vf, vt,
                pp.islast_at[t0:t1], pp.start_char[t0:t1], k, all_minima,
                tend if g.n_prev else None, g.alpha, g.n_prev,
            )
        cols[0] = g.qidx[q0 + cols[0]]
        cols[1] = pp.text_idx[t0 + cols[1]]
        return cols, carry

    def dispatch(self, profile: Profile, ts: TextSet, g: _Group, k: int,
                 all_minima: bool, reverse: bool) -> list[torch.Tensor]:
        """Scan and select every chunk of one group on the current stream;
        returns the chunks' device columns. The first chunk's descriptor
        uploads the text set and packs the strand's planes where they are
        not cached yet."""
        pp = ts.piece_plan(g.halo, g.w_chars, g.steps)
        found = []
        carry = None
        for q0, q1, t0, t1 in self.chunks(g, pp):
            if t0 == 0:
                carry = torch.zeros((q1 - q0, 1), dtype=torch.int32,
                                    device=self.device)
            win = ts.descriptor(profile, pp, reverse, t0, t1)
            with spans.span("launch", chunks=1):
                saved = ((q1 - q0) * (g.pmasks.shape[1] - g.hier_s) * pp.NW
                         * (t1 - t0))
                if g.hier_s and saved >= plan.HIER_MIN_SAVED_PAIRS:
                    cols, carry = self._scan_flagged(win, g, pp, q0, q1, t0,
                                                     t1, k, all_minima, carry)
                    if cols is not None:
                        found.append(cols)
                    continue
                outs = self.scan(win, g, pp, q0, q1, t0, t1, k)
                del win
                for s0, s1 in self.select_ranges(g, pp, q1 - q0, t0, t1,
                                                 outs[0].device):
                    part = tuple(o[..., s0 - t0 : s1 - t0] for o in outs)
                    cols, carry = self.select(part, g, pp, q0, s0, s1, k,
                                              all_minima, carry)
                    found.append(cols)
        return found

    def _scan_flagged(self, win, g: _Group, pp: PiecePlan, q0, q1, t0, t1,
                      k: int, all_minima: bool, carry):
        """One chunk through the suffix prefilter: the full scan and the
        selection over the flagged pieces only, whose state chain runs
        over them as neighbours (every owned position of a piece left out
        costs > k, so no plateau of candidates reaches across it;
        reference batch.py:643-662). Returns the candidates' columns
        (None without a flagged piece) and the state carried on: that
        after the chunk's last piece if it was flagged, else 0, as the
        state carried in counts only if the chunk's first piece is."""
        ids = self.flagged_pieces(win, g, pp, q0, q1, t0, t1, k)
        if ids.numel() == 0:
            return None, torch.zeros_like(carry)
        with spans.span("device_wait", device_waits=1):
            first, last = ids[[0, -1]].tolist()
        if first != 0:
            carry = torch.zeros_like(carry)
        sub = pp.take(t0 + ids)
        outs = self.scan(win.take(ids), g, sub, q0, q1, 0, sub.T, k)
        cols, carry = self.select(outs, g, sub, q0, 0, sub.T, k, all_minima,
                                  carry)
        if last != t1 - t0 - 1:
            carry = torch.zeros_like(carry)
        return cols, carry

    def candidates_many(self, profile: Profile, pattern_codes, texts, k: int,
                        alpha=None, max_overhang=None, all_minima=False,
                        reverse=False) -> list[list]:
        """``out[q][t]``: sorted [(end_pos, cost)] (``()`` if none).
        ``reverse``: scan the character-reversed texts (the RC strand);
        positions come back in reversed-text coordinates."""
        return self.candidates_many_async(
            profile, pattern_codes, texts, k, alpha, max_overhang,
            all_minima, reverse,
        )()

    def candidates_many_flat(self, *args, **kw):
        """Like ``candidates_many`` but returns flat sorted numpy columns
        ``(q, text_idx, pos, cost)``."""
        return self.candidates_many_async(*args, **kw, _flat=True)()

    def candidates_many_flat_async(self, *args, **kw):
        return self.candidates_many_async(*args, **kw, _flat=True)

    def candidates_many_async(self, profile: Profile, pattern_codes, texts,
                              k: int, alpha=None, max_overhang=None,
                              all_minima=False, reverse=False,
                              _flat=False):
        """Start the whole workload on the dispatch thread, on the caller's
        current stream, and return a ``finish()`` callable that waits for
        its candidates on the host and decodes them. Errors of the dispatch
        are raised by ``finish()``."""
        ts = self.textset(texts)
        Q, NT = len(pattern_codes), len(ts.lens)

        def run() -> np.ndarray:
            found: list[torch.Tensor] = []
            if Q and NT:
                with spans.span("groups"):
                    groups = self.groups(profile, pattern_codes, ts, k,
                                         alpha, max_overhang)
                for g in groups:
                    found += self.dispatch(profile, ts, g, k, all_minima,
                                           reverse)
            return _fetch(found)

        job = dispatch_async(self.device, run)

        def finish():
            with spans.span("wait"):
                cols = job.result()
            with spans.span("decode"):
                return _decode(cols, Q, NT, _flat)
        return finish


def _fetch(found: list[torch.Tensor]) -> np.ndarray:
    """The chunks' device columns -> one (4, N) int64 host array, in one
    copy."""
    if not found:
        return np.zeros((4, 0), np.int64)
    cols = torch.cat(found, 1)
    with spans.span("device_wait", device_waits=1):
        return cols.cpu().numpy()


def _decode(cols: np.ndarray, Q: int, NT: int, flat: bool):
    """Host columns -> sorted by (q, text, pos, cost): flat numpy columns,
    or the dense ``out[q][t]`` lists."""
    order = np.lexsort(cols[::-1])
    qs, ti, ps, cs = cols[:, order]
    if flat:
        return qs.astype(np.int32), ti.astype(np.int32), ps, cs
    empty: tuple = ()
    dense: list[list] = [[empty] * NT for _ in range(Q)]
    if len(qs):
        cell = qs * NT + ti
        cuts = np.nonzero(np.diff(cell))[0] + 1
        starts = np.concatenate(([0], cuts)).tolist()
        ends = np.concatenate((cuts, [len(cell)])).tolist()
        pl, cl = ps.tolist(), cs.tolist()
        for s, e in zip(starts, ends):
            dense[qs[s]][ti[s]] = list(zip(pl[s:e], cl[s:e]))
    return dense
