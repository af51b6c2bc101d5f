"""Windowed DP re-fill and greedy CIGAR traceback.

Mirrors the reference's candidate post-processing: each candidate end
position gets a text window ``[end - (m+k), end)``; the DP is re-computed
over the window and a greedy backwards walk extracts the alignment
(sassy src/search.rs:1372-1689 ``process_matches`` +
sassy src/trace.rs:273-406 ``get_trace``).

Op preference is fixed: Match, then (after spending one edit) Sub, then Del
(consumes text), then Ins (consumes pattern) — trace.rs:338-365, as the
upstream sassy project pinned it.

The window DP always uses the overhang-discounted left boundary when alpha
is set, even for windows that don't start at the text start — harmless
because for such windows the left column is only reachable at j=0
(trace.rs:141-146 note), and it matches the reference bit-for-bit.

The port's own copy of ``sassy_tpu/traceback.py`` (the port imports nothing
of the JAX package); tests/test_torch_copies.py holds the two equal.

The batched finish (``trace_cells_batch``) reads each candidate's window
from the strand's bit-planes (``StrandPlanes``), the planes the search
packed, never from the host bytes: on the card the traceback kernel of
``myers_cuda.trace_windows`` (``csrc/trace.cu``: decode, fill and walk, one
thread a candidate), on the CPU its plain version ``trace_plain``
(``window_codes``, ``_fill_batch``, ``_walk_batch``). The host keeps the
CIGARs' build (``_cigars``), and the bytes of a window only where they are
read: the N counts (``TextSpans``) and a failed walk's diagnostics.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import collector, spans
from .cigar import DEL, INS, MATCH, SUB, Cigar
from .matchrec import Match, Strand
from .oracle import dp_matrix
from .ops import myers_cuda
from .ops.bitpack import WORD_BITS
from .ops.myers_cuda import TRACE_FIELDS
from .profiles import Profile, as_bytes_array
from .semantics import overshoot_cost

__all__ = ["trace_candidate", "trace_candidates_batch", "trace_cells_batch",
           "trace_plain", "trace_tables", "window_codes", "unpack_trace",
           "host_planes", "StrandPlanes", "TextSpans", "Traced",
           "TraceError"]


class TraceError(RuntimeError):
    """Raised when no backward step is consistent — the reference panics here
    with an invalid-alphabet hint (trace.rs:367-387)."""


#: the bytes one fill's (m + 1, w + 1, B) int32 cost matrices and (m, w,
#: B) match masks may take: a larger batch of windows is filled and walked
#: in chunks under it
FILL_BYTES = 256 << 20
#: a text whose windows span more bytes than this is read in place; the
#: spans of the others (reads, short contigs) are copied into one array
#: and read by one gather, so the copy never holds a long text
SPAN_COPY_BYTES = 1 << 16
#: the rows one gather's index array covers
GATHER_ROWS = 1 << 16
#: a fill of fewer candidates than this takes each row's running minimum
#: with one ``np.minimum.accumulate`` along the columns; a larger one with
#: one ``np.minimum`` a column (the accumulate's stride over the
#: candidates costs more than the w + 1 calls from about 400 candidates
#: on, at any width)
ACCUMULATE_BELOW = 384
#: a source of ``TextSpans`` counts its rows' N bytes by gathering them
#: when its rows x their widest range x this is less than its bytes (a
#: few windows in a long text), else by binary searches in the positions
#: of its N bytes (one pass over its bytes)
N_GATHER_COST = 8


class TextSpans:
    """Where the bytes of many rows lie: row b is the ``lens[b]`` bytes of
    text ``tids[b]`` from ``starts[b]`` on, of the text read backwards
    with ``reverse`` (no reversed copy is made). Every row's bytes must lie
    in its text.

    The span of each text that its rows need is copied into one array; a
    text whose span is larger than ``SPAN_COPY_BYTES`` is read in place.
    ``windows`` reads every row with one gather a block of
    ``GATHER_ROWS`` rows; ``n_counts`` counts N bytes with a gather of
    the rows' ranges, or with two binary searches a row in the positions
    of the N bytes of a source with many rows."""

    def __init__(self, texts, text_lens: np.ndarray, tids, starts, lens,
                 reverse: bool = False):
        self.text_lens, self.reverse = text_lens, reverse
        self.n_rows = len(tids)
        tids = np.asarray(tids, np.int64)
        lens = np.asarray(lens, np.int64)
        rows = np.flatnonzero(lens > 0)
        t = tids[rows]
        order = np.argsort(t, kind="stable")
        # the rows with bytes, those of one text in a run, each as a
        # forward range [lo, hi) of its text
        self.rows, self.t = rows[order], t[order]
        self.lo = self._forward(self.t, np.asarray(starts, np.int64)[
            self.rows], lens[self.rows])
        self.hi = self.lo + lens[self.rows]
        # text r's rows are first[r] to ends[r]
        first = np.flatnonzero(np.r_[True, self.t[1:] != self.t[:-1]])
        ends = np.r_[first[1:], len(self.t)]
        run = np.repeat(np.arange(len(first)), ends - first)
        self.shift = np.zeros(len(self.t), np.int64)
        # (bytes, the rows they hold): the copied spans, then each text
        # read in place; a row's position p lies at bytes[p + shift]
        self.sources = []
        self._n_at = {}  # a source's N positions, once
        if not len(first):
            return
        span_lo = np.minimum.reduceat(self.lo, first)
        span_hi = np.maximum.reduceat(self.hi, first)
        copy = span_hi - span_lo <= SPAN_COPY_BYTES
        span_t = self.t[first]
        if copy.any():
            size = np.where(copy, span_hi - span_lo, 0)
            self.shift = (np.cumsum(size) - size - span_lo)[run]
            self.sources.append((np.concatenate([
                texts[i][a:z] for i, a, z in zip(
                    span_t[copy].tolist(), span_lo[copy].tolist(),
                    span_hi[copy].tolist())]),
                np.flatnonzero(copy[run])))
        for r in np.flatnonzero(~copy).tolist():
            sel = np.arange(first[r], ends[r])
            self.shift[sel] = -span_lo[r]
            self.sources.append(
                (texts[span_t[r]][span_lo[r] : span_hi[r]], sel))

    def _forward(self, t, starts, lens):
        """The forward start of ``lens`` bytes from ``starts`` of texts
        ``t`` (read backwards with ``reverse``)."""
        return self.text_lens[t] - starts - lens if self.reverse else starts

    def windows(self, width: int) -> np.ndarray:
        """(B, width) uint8: each row's bytes, then zeros (``lens`` <=
        ``width``)."""
        out = np.zeros((self.n_rows, width), np.uint8)
        cols = np.arange(width)
        for src, sel in self.sources:
            for s in range(0, len(sel), GATHER_ROWS):
                b = sel[s : s + GATHER_ROWS]
                at = (self.hi[b, None] - 1 - cols if self.reverse
                      else self.lo[b, None] + cols) + self.shift[b, None]
                ok = cols < (self.hi[b] - self.lo[b])[:, None]
                out[self.rows[b]] = np.where(ok, src[np.where(ok, at, 0)], 0)
        return out

    def n_counts(self, starts, ends) -> np.ndarray:
        """The 'N'/'n' bytes at each row's positions ``starts[b]`` to
        ``ends[b]`` (the rows' own coordinates, inside the row's bytes; an
        empty range counts 0)."""
        rows = self.rows
        ln = np.maximum(np.asarray(ends, np.int64)[rows]
                        - np.asarray(starts, np.int64)[rows], 0)
        a = self._forward(self.t, np.asarray(starts, np.int64)[rows], ln)
        a += self.shift
        count = np.zeros(self.n_rows, np.int64)
        for i, (src, sel) in enumerate(self.sources):
            width = int(ln[sel].max())
            if len(sel) * width * N_GATHER_COST < len(src):
                cols = np.arange(width)
                for s in range(0, len(sel), GATHER_ROWS):
                    b = sel[s : s + GATHER_ROWS]
                    ok = cols < ln[b, None]
                    byte = src[np.where(ok, a[b, None] + cols, 0)]
                    count[rows[b]] = np.count_nonzero(
                        ok & ((byte | 0x20) == ord("n")), axis=1)
                continue
            if i not in self._n_at:
                self._n_at[i] = np.flatnonzero((src | 0x20) == ord("n"))
            n_at = self._n_at[i]
            count[rows[sel]] = (np.searchsorted(n_at, a[sel] + ln[sel])
                                - np.searchsorted(n_at, a[sel]))
        return count


def _fill_batch(
    profile: Profile,
    pattern_codes: np.ndarray,  # (B, m): each window's pattern
    wins: np.ndarray,  # (B, w) engine codes, right-padded
    alpha: float | None,
    max_overhang: int | None,
    boundary: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Batched windowed DP fill: one vectorized pass over all B windows,
    each against its own pattern (all of one length).

    The role of the reference's ``simd_fill`` (trace.rs:107-178): candidate
    windows are re-filled together so the fill cost amortizes over the
    batch instead of paying the per-row dispatch overhead per candidate.
    Right-padding is harmless — each candidate's walk only reads columns
    up to its own window length.

    Returns ``E`` (m + 1, w + 1, B) int32, the cost matrices less their
    column index (``D[b, j, i] = E[j, i, b] + i``), and the match mask
    (m, w, B) bool. The candidates are the last axis, so that every step
    is one operation over the batch: in this form a row is
    ``E[j, i] = min(E[j-1, i-1] - match, E[j-1, i] + 1, E[j, i-1])``.
    ``boundary``: the left column's costs over rows 0..m (row 0 of
    ``trace_tables``), instead of those of ``alpha`` and
    ``max_overhang``.
    """
    from .semantics import left_boundary_costs

    B, w = wins.shape
    m = pattern_codes.shape[1]
    if boundary is None:
        boundary = left_boundary_costs(m, alpha, max_overhang)
    wt = np.ascontiguousarray(wins.T)[None]  # (1, w, B)
    pt = np.ascontiguousarray(pattern_codes.T)
    E = np.empty((m + 1, w + 1, B), dtype=np.int32)
    E[:, 0] = boundary[:, None]
    E[0, 1:] = -np.arange(1, w + 1, dtype=np.int32)[:, None]
    mm = np.empty((m, w, B), dtype=bool)
    step = np.empty((w + 1, B), dtype=np.int32)
    for j in range(1, m + 1):
        prev, row = E[j - 1], E[j]
        # the profile's test of pattern row j - 1 against every column:
        # match_mask(p, t) is p[:, None] op t[None, :], here (1, w, B)
        mm[j - 1] = profile.match_mask(pt[j - 1][None], wt)[0]
        np.add(prev[1:], 1, out=step[1:])
        np.minimum(step[1:], prev[:-1] - mm[j - 1], out=step[1:])
        step[0] = boundary[j]
        # the running minimum along the row: one strided accumulate for a
        # few candidates, one operation a column over many
        if B < ACCUMULATE_BELOW:
            np.minimum.accumulate(step, axis=0, out=row)
        else:
            row[0] = step[0]
            for i in range(1, w + 1):
                np.minimum(row[i - 1], step[i], out=row[i])
    return E, mm


class Traced(NamedTuple):
    """A traced batch, row for row: each match's cost, coordinates (in its
    text as it was read) and CIGAR."""

    cost: np.ndarray
    text_start: np.ndarray
    text_end: np.ndarray
    pattern_start: np.ndarray
    pattern_end: np.ndarray
    cigars: list


class StrandPlanes(NamedTuple):
    """A strand's bit-planes as its search packed them, and where each text
    lies in them: code bit p of position x of text t (in the strand: the
    text read backwards for the reverse strand) is bit x % 32 of
    ``planes[p, word0[t] + x // 32]``. ``planes``: (P[+1], L) int32 on the
    card or the CPU; ``word0``: (T,) int64 on the host."""

    planes: torch.Tensor
    word0: np.ndarray


def trace_tables(m: int, alpha: float | None,
                 max_overhang: int | None) -> np.ndarray:
    """(3, m + 1) int32 over rows 0..m: the left boundary's costs
    (``semantics.left_boundary_costs``), the start overshoot's cost of a
    walk that stops at column 0 in row j (the float32 floor of
    ``_walk``), and the end overshoot's cost of an end ``over`` past the
    window (``semantics.overshoot_costs_vec``). The traceback's overhang
    math, done once on the host for the kernel and its plain version."""
    from .semantics import left_boundary_costs, overshoot_costs_vec

    jj = np.arange(m + 1, dtype=np.int64)
    if alpha is None:
        start = np.zeros(m + 1, np.int64)
    elif max_overhang is not None:
        start = np.floor(np.minimum(jj, max_overhang).astype(np.float32)
                         * np.float32(alpha)).astype(np.int64) + np.maximum(
                             0, jj - max_overhang)
    else:
        start = np.floor(jj.astype(np.float32)
                         * np.float32(alpha)).astype(np.int64)
    return np.stack([left_boundary_costs(m, alpha, max_overhang), start,
                     overshoot_costs_vec(alpha, jj)]).astype(np.int32)


def window_codes(planes: torch.Tensor, profile: Profile, base: np.ndarray,
                 wlens: np.ndarray, width: int) -> np.ndarray:
    """(B, width) uint8 engine codes of each row's window, read from the
    planes (on any device): row b's column c < ``wlens[b]`` is the code at
    bit position ``base[b] + c`` (32 word0 + the window's offset), its
    other columns ``profile.pad_code``. ``GATHER_ROWS`` rows a gather."""
    B = len(base)
    out = np.empty((B, width), np.uint8)
    dev = planes.device
    cols = torch.arange(width, dtype=torch.int64, device=dev)
    for s in range(0, B, GATHER_ROWS):
        x = torch.from_numpy(np.ascontiguousarray(
            base[s : s + GATHER_ROWS])).to(dev)[:, None] + cols
        ok = cols < torch.from_numpy(np.ascontiguousarray(
            wlens[s : s + GATHER_ROWS])).to(dev)[:, None]
        x = torch.where(ok, x, 0)
        words = planes[: profile.planes][:, x >> 5]  # (P, b, width)
        bit = (x & 31).to(torch.int32)
        code = torch.zeros(x.shape, dtype=torch.int32, device=dev)
        for p in range(profile.planes):
            code |= ((words[p] >> bit) & 1) << p
        code = torch.where(ok, code, profile.pad_code)
        out[s : s + GATHER_ROWS] = code.to(torch.uint8).cpu().numpy()
    return out


def unpack_trace(buf: np.ndarray, m: int, fill_len: int):
    """A trace's (B, stride) int32 output rows as ``_walk_batch`` returns
    them: each candidate's start in its window, total cost, pattern start
    and end (int64), its (B, m + fill_len + 1) int8 ops (-1 past the
    walk's end) and where it failed."""
    f = buf[:, :TRACE_FIELDS].astype(np.int64)
    ops = np.ascontiguousarray(buf[:, TRACE_FIELDS:]).view(np.int8)
    return (f[:, 0], f[:, 1], f[:, 2], f[:, 3],
            ops[:, : m + fill_len + 1], f[:, 4] != 0)


def trace_plain(planes: torch.Tensor, pcodes: torch.Tensor,
                cand: torch.Tensor, tables: torch.Tensor, profile: Profile,
                fill_len: int, alpha_on: bool, chunk: int | None = None,
                split: dict | None = None) -> torch.Tensor:
    """Plain version of the traceback kernel (``myers_cuda.trace_windows``),
    on its inputs: the strand's planes (on any device), the length group's
    (Q, m) uint8 pattern codes, (5, B) int64 candidate columns (pattern,
    its text's first plane word, window offset, window length, end) and
    ``trace_tables``. Decodes the windows from the planes
    (``window_codes``), then fills and walks ``chunk`` candidates at a
    time (``_fill_batch``, ``_walk_batch``). Returns the (B, stride) int32
    output rows on the CPU (``unpack_trace``), -1 in every op byte past a
    walk's end, as the kernel writes them. ``split``: as
    ``trace_cells_batch``'s (the window decode under "gather")."""
    trace_plain.calls += 1
    with spans.step(split, "gather"):
        pid, word0, off, wlen, end = cand.cpu().numpy()
        pc = pcodes.cpu().numpy()
        tab = tables.cpu().numpy()
        B, m = len(pid), pc.shape[1]
        codes = window_codes(planes, profile, word0 * WORD_BITS + off, wlen,
                             fill_len)
    spans.add(split, windows=B)
    out = np.full((B, TRACE_FIELDS + -(-(m + fill_len + 1) // 4)), -1,
                  np.int32)
    ops_out = out[:, TRACE_FIELDS:].view(np.int8)
    step = max(1, chunk or B)
    for s in range(0, B, step):
        c = slice(s, s + step)
        with spans.step(split, "fill"):
            E, mm = _fill_batch(profile, pc[pid[c]], codes[c], None, None,
                                tab[0])
        with spans.step(split, "walk"):
            i, total, pat_start, pat_end, ops, failed = _walk_batch(
                E, mm, end[c] - off[c], wlen[c], tab, alpha_on)
            out[c, :TRACE_FIELDS] = np.stack(
                [i, total, pat_start, pat_end, failed], axis=1)
            ops_out[c, : ops.shape[1]] = ops
    return torch.from_numpy(out)


trace_plain.calls = 0


def host_planes(profile: Profile, text) -> StrandPlanes:
    """The planes of one host text on the CPU (``myers_torch.pack_plain``),
    as a one-text ``StrandPlanes``."""
    from .ops.myers_torch import pack_plain

    text = as_bytes_array(text)
    n = len(text)
    planes = pack_plain(torch.from_numpy(text.copy()), n // WORD_BITS,
                        n % WORD_BITS, profile.planes, False,
                        profile.pack_mode, profile.pack_shift,
                        profile.pack_mask, tuple(profile.pack_plane_masks),
                        profile.pack_fold_case, max(1, -(-n // WORD_BITS)))
    return StrandPlanes(planes, np.zeros(1, np.int64))


def trace_cells_batch(
    profile: Profile,
    patterns,
    pattern_codes,
    texts,
    text_lens: np.ndarray,
    pids,
    tids,
    ends,
    fill_len: int,
    alpha: float | None,
    max_overhang: int | None,
    planes: StrandPlanes,
    reverse: bool = False,
    split: dict | None = None,
) -> Traced:
    """Re-align and trace the candidates of many patterns of one length
    over many texts: candidate b is pattern ``pids[b]`` (``patterns`` and
    ``pattern_codes`` are indexed by it) ending at ``ends[b]`` in text
    ``tids[b]``, read backwards with ``reverse``.

    Every window ``[end - fill_len, min(end, n))`` is read from the
    strand's ``planes`` (a ``StrandPlanes``): on the card by the traceback
    kernel (``myers_cuda.trace_windows``: its inputs uploaded, one launch
    a chunk of at most ``FILL_BYTES`` of cost matrices, its output rows
    copied to the host once), on the CPU by ``trace_plain``. A failed walk
    is walked again on the host from its text's bytes (``texts``), which
    raises the reference's ``TraceError``. ``split``, a dict, gets the
    seconds of the trace ("trace" on the card; the plain version's
    "gather", "fill" and "walk" on the CPU), of the rows' unpacking
    ("unpack") and the CIGARs' build ("cigars"), both also under "build",
    the collector's passes during those two ("gc_passes", "gc_s"), and
    the windows' count."""
    pids = np.asarray(pids, np.int64)
    tids = np.asarray(tids, np.int64)
    ends = np.asarray(ends, np.int64)
    B = len(ends)
    if not B:
        none = np.zeros(0, np.int64)
        return Traced(none, none, none, none, none, [])
    on_card = planes.planes.device.type != "cpu"
    # on the card the whole trace is one step; on the CPU its plain
    # version's steps are
    with (spans.step(split, "trace") if on_card else spans.span("trace")):
        offsets = np.maximum(0, ends - fill_len)
        wlens = np.minimum(ends, text_lens[tids]) - offsets
        used, pidx = np.unique(pids, return_inverse=True)
        pcodes = np.stack([pattern_codes[q] for q in used.tolist()])
        m = pcodes.shape[1]
        word0 = planes.word0[tids]
        L = planes.planes.shape[1]
        if (ends - offsets - wlens > m).any() or (
                word0 + -(-(offsets + wlens) // WORD_BITS) > L).any():
            raise ValueError("a candidate ends more than m past its text, "
                             "or its window lies past the planes")
        tables = trace_tables(m, alpha, max_overhang)
        cand = np.stack([pidx.astype(np.int64), word0, offsets, wlens, ends])
        # the fill's matrices and match mask, a candidate
        chunk = max(1, FILL_BYTES // ((m + 1) * (fill_len + 1) * 4
                                      + m * fill_len))
        dev = planes.planes.device
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in (pcodes, cand, tables)]
        if on_card:
            buf = myers_cuda.trace_windows(planes.planes, *args, profile,
                                           fill_len, alpha is not None,
                                           chunk).cpu()
        else:
            buf = trace_plain(planes.planes, *args, profile, fill_len,
                              alpha is not None, chunk, split)
    if on_card:
        spans.add(split, windows=B)
    with collector.paused(split), spans.span("build"):
        with spans.step(split, "unpack", build=True):
            i, total, pat_start, pat_end, ops, failed = unpack_trace(
                buf.numpy(), m, fill_len)
        with spans.step(split, "cigars", build=True):
            if failed.any():
                _raise_failed(profile, patterns, pcodes[pidx], texts,
                              text_lens, pids, tids, ends, offsets, wlens,
                              fill_len, alpha, max_overhang, reverse,
                              np.flatnonzero(failed), chunk)
            longest = int(np.count_nonzero(ops >= 0, axis=1).max())
            cigars = _cigars(ops[:, :longest])
    return Traced(total, offsets + i, offsets + wlens, pat_start, pat_end,
                  cigars)


def _raise_failed(profile, patterns, pcodes, texts, text_lens, pids, tids,
                  ends, offsets, wlens, fill_len, alpha, max_overhang,
                  reverse, bad, chunk):
    """The exact error of the first failed walk: each of ``bad`` walked
    again by the scalar walk, on its own pattern and its own text's window
    (its bytes gathered by ``TextSpans`` and filled on the host)."""
    cols = np.arange(fill_len + 1)
    for s in range(0, len(bad), chunk):
        rows = bad[s : s + chunk]
        raw = TextSpans(texts, text_lens, tids[rows], offsets[rows],
                        wlens[rows], reverse).windows(fill_len)
        codes = profile.encode(raw)
        codes[np.arange(fill_len) >= wlens[rows][:, None]] = profile.pad_code
        E, _ = _fill_batch(profile, pcodes[rows], codes, alpha, max_overhang)
        for r, b in enumerate(rows.tolist()):
            _walk(profile, patterns[pids[b]], raw[r, : wlens[b]],
                  E[:, :, r] + cols, int(ends[b]), int(offsets[b]),
                  int(wlens[b]), alpha, max_overhang)
    raise TraceError("vectorized walk failed but scalar walk passed")


def trace_candidates_batch(
    profile: Profile,
    pattern: np.ndarray,
    pattern_codes: np.ndarray,
    text: np.ndarray,
    ends: list[int],
    fill_len: int,
    alpha: float | None,
    max_overhang: int | None,
) -> list[Match]:
    """Re-align and trace a batch of candidate end positions of one pattern
    in one text, in ONE fill (``trace_cells_batch`` with one cell, on the
    text's planes packed on the CPU).

    The reference's ``process_matches`` batches LANES candidates per
    ``simd_fill`` (search.rs:1372-1689, trace.rs:107-178); here the batch is
    all candidates of the (pattern, text) pair — the windowed DP matrices
    are computed together (vectorized over the batch axis), then each
    candidate's greedy walk reads its own precomputed matrix.
    """
    if not ends:
        return []
    text = as_bytes_array(text)
    zeros = np.zeros(len(ends), np.int64)
    tr = trace_cells_batch(profile, [pattern], [pattern_codes], [text],
                           np.array([len(text)], np.int64), zeros, zeros,
                           ends, fill_len, alpha, max_overhang,
                           host_planes(profile, text))
    return [
        Match(pattern_idx=0, text_idx=0, cost=c, text_start=ts, text_end=te,
              pattern_start=ps, pattern_end=pe, strand=Strand.FWD, cigar=cg)
        for c, ts, te, ps, pe, cg in zip(
            tr.cost.tolist(), tr.text_start.tolist(), tr.text_end.tolist(),
            tr.pattern_start.tolist(), tr.pattern_end.tolist(), tr.cigars)
    ]


def _walk_batch(
    E: np.ndarray,  # (m+1, w+1, B) cost matrices less their column index
    mm: np.ndarray,  # (m, w, B) match mask (pattern row x window col)
    rel_ends: np.ndarray,  # each end position less its window's offset
    wlens: np.ndarray,
    tables: np.ndarray,  # trace_tables: the overshoots' costs over 0..m
    alpha_on: bool,
):
    """Vectorized greedy walks: ALL candidates step together.

    Each iteration advances every still-active candidate by one op,
    chosen with the reference's fixed preference (=, X, D, I —
    trace.rs:338-365) from four vectorized matrix gathers; op codes are
    recorded per step, in walk order. Replaces the per-candidate Python
    walk that cost ~44 us/candidate (is_match + push dominating) — the
    walk itself is now O(path length) numpy passes over the whole batch.
    ``E`` and ``mm`` are ``_fill_batch``'s; the end and start
    overshoots' costs are rows 2 and 1 of ``trace_tables`` (the start
    overshoot with ``alpha_on``).

    Returns each candidate's text start in its window, total cost, pattern
    start and end, the (B, steps) int8 ops (0-3: =, X, D, I; -1 past the
    walk's end) and where the walk failed (no consistent step, or cost
    left at its end).
    """
    m = E.shape[0] - 1
    w = E.shape[1] - 1
    B = E.shape[2]
    ar = np.arange(B)
    Ev = E.reshape(-1)
    mmv = mm.reshape(-1)
    wl_a = np.asarray(wlens, dtype=np.int64)


    # end overshoot: walk straight back along the virtual 'N' diagonal
    i = np.asarray(rel_ends, dtype=np.int64)
    over = np.maximum(i - wl_a, 0)
    pat_end = m - over
    i = i - over
    j = np.full(B, m, dtype=np.int64) - over
    g = Ev[(j * (w + 1) + i) * B + ar] + i  # D[b, j[b], i[b]]
    total = g + tables[2][over]
    pat_start = np.zeros(B, dtype=np.int64)

    S = m + w + 1
    ops = np.full((B, S), -1, dtype=np.int8)
    act = j > 0
    bad = np.zeros(B, dtype=bool)
    step = 0
    while act.any():
        if step >= S:  # cannot happen: every op consumes i and/or j
            raise TraceError("trace walk exceeded the maximum path length")
        if alpha_on:
            # start overshoot: remaining pattern prefix hangs off the
            # text start (trace.rs:322-335)
            stop0 = act & (i == 0)
            if stop0.any():
                jj = j[stop0]
                pat_start[stop0] = jj
                g[stop0] -= tables[1][jj]
                act = act & ~stop0
                if not act.any():
                    break
        # E at (j, i) and its three neighbours, compared with g - i: D is
        # E plus the column, so D[j-1, i-1] == g is E == g - i + 1. A
        # candidate at i = 0 or j = 0 reads a wrapped index, which its
        # masks ignore
        at = (j * (w + 1) + i) * B + ar
        gi = g - i
        e_diag = Ev.take(at - (w + 2) * B, mode="wrap")
        mat = (mmv.take(at - (j + w + 1) * B, mode="wrap") if m and w
               else np.zeros(B, bool))
        can_i = i > 0
        is_m = act & can_i & (e_diag == gi + 1) & mat
        rest = act & ~is_m
        is_s = rest & can_i & (e_diag == gi)
        rest = rest & ~is_s
        is_d = rest & can_i & (Ev.take(at - B, mode="wrap") == gi)
        rest = rest & ~is_d
        is_i = rest & (Ev.take(at - (w + 1) * B, mode="wrap") == gi - 1)
        newbad = rest & ~is_i
        if newbad.any():
            # defer: re-run those through the scalar walk for the exact
            # reference-style diagnostics
            bad |= newbad
            act = act & ~newbad
        ops[:, step] = np.where(is_m | is_s | is_d | is_i,
                                is_s + 2 * is_d + 3 * is_i, -1)
        g = np.where(is_m | ~act, g, g - 1)
        j = j - (is_m | is_s | is_i)
        i = i - (is_m | is_s | is_d)
        act = act & (j > 0)
        step += 1
    return i, total, pat_start, pat_end, ops[:, :step], bad | (g != 0)


#: the op of each walk code (0 =, 1 X, 2 D, 3 I)
_OP_CHARS = (MATCH, SUB, DEL, INS)


def _cigars(ops: np.ndarray) -> list[Cigar]:
    """Each row's ops (walk order, as ``_walk_batch`` gives them) as a
    Cigar read forward. A batch has few distinct rows: each one's
    (op, length) runs are made once, as tuples its rows' Cigars share;
    every row gets its own Cigar and its own list of runs (``Cigar.push``
    changes the list)."""
    B, step = ops.shape
    if not step:
        return [Cigar([]) for _ in range(B)]
    rows = np.ascontiguousarray(ops).view(np.dtype((np.void, step)))
    uniq, inv = np.unique(rows.reshape(-1), return_inverse=True)
    ops = uniq.view(np.int8).reshape(-1, step)
    U = len(ops)
    # each row's valid ops are a prefix; read it backwards (forward along
    # the pattern), -1 past it
    n_ops = np.count_nonzero(ops >= 0, axis=1)
    back = n_ops[:, None] - 1 - np.arange(step)
    fwd = np.where(back >= 0,
                   np.take_along_axis(ops, np.maximum(back, 0), axis=1), -1)
    # run-length encode every row at once: values tagged with the row id
    # so runs cannot span rows, then one np.nonzero pass yields every
    # (row, op, length) run, rows in order
    flat = (fwd.astype(np.int64) + (np.arange(U)[:, None] << 8)).reshape(-1)
    chg = np.ones(flat.shape[0], dtype=bool)
    chg[1:] = flat[1:] != flat[:-1]
    starts = np.flatnonzero(chg)
    lens = np.diff(np.append(starts, flat.shape[0]))
    vals = fwd.reshape(-1)[starts]
    keep = vals >= 0
    starts, lens, vals = starts[keep], lens[keep], vals[keep]
    runs = list(zip(map(_OP_CHARS.__getitem__, vals.tolist()),
                    lens.tolist()))
    cut = np.searchsorted(starts // step, np.arange(U + 1)).tolist()
    shared = [tuple(runs[a:z]) for a, z in zip(cut[:-1], cut[1:])]
    return list(map(Cigar, map(list, map(shared.__getitem__,
                                         inv.reshape(-1).tolist()))))


def trace_candidate(
    profile: Profile,
    pattern: np.ndarray,
    pattern_codes: np.ndarray,
    text: np.ndarray,
    end_pos: int,
    fill_len: int,
    alpha: float | None,
    max_overhang: int | None,
) -> Match:
    """Re-align and trace one candidate end position.

    Args:
        pattern/text: raw bytes (uint8 arrays) — used for the is_match check.
        pattern_codes: engine codes. The text window is encoded here (only
        the m+k window is touched — the full text is never re-encoded).
        end_pos: candidate end position (may exceed len(text) with overhang).
        fill_len: window length, ``m + k``.

    Returns a Match with coordinates in this text (strand FWD; the caller
    flips RC coordinates).
    """
    n = len(text)
    offset = max(0, end_pos - fill_len)
    win_end = min(end_pos, n)
    win = slice(offset, win_end)
    wtext = text[win]
    wcodes = profile.encode(wtext)
    wlen = win_end - offset

    D = dp_matrix(profile, pattern_codes, wcodes, alpha, max_overhang)
    return _walk(
        profile, pattern, wtext, D, end_pos, offset, wlen, alpha, max_overhang
    )


def _walk(
    profile: Profile,
    pattern: np.ndarray,
    wtext: np.ndarray,
    D: np.ndarray,
    end_pos: int,
    offset: int,
    wlen: int,
    alpha: float | None,
    max_overhang: int | None,
) -> Match:
    """Greedy backwards walk of one windowed cost matrix (trace.rs:273-406)."""
    m = len(pattern)
    j = m
    i = end_pos - offset
    pattern_start = 0
    pattern_end = m

    # End overshoot: walk straight back along the virtual 'N' diagonal
    # (trace.rs:300-312).
    if i > wlen:
        overshoot = i - wlen
        pattern_end -= overshoot
        oc = overshoot_cost(alpha, overshoot)
        i -= overshoot
        j -= overshoot
        g = int(D[j, i])
        total_cost = g + oc
    else:
        g = int(D[j, i])
        total_cost = g

    cigar = Cigar()
    while True:
        if j == 0:
            break
        if i == 0 and alpha is not None:
            # Start overshoot: remaining pattern prefix hangs off the text
            # start (trace.rs:322-335).
            pattern_start = j
            if max_overhang is not None:
                oc = int(
                    np.floor(np.float32(min(j, max_overhang)) * np.float32(alpha))
                ) + max(0, j - max_overhang)
            else:
                oc = int(np.floor(np.float32(j) * np.float32(alpha)))
            g -= oc
            break

        if i > 0 and D[j - 1, i - 1] == g and profile.is_match(
            int(pattern[j - 1]), int(wtext[i - 1])
        ):
            cigar.push(MATCH)
            j -= 1
            i -= 1
            continue
        g -= 1
        if i > 0 and D[j - 1, i - 1] == g:
            cigar.push(SUB)
            j -= 1
            i -= 1
            continue
        if i > 0 and D[j, i - 1] == g:
            cigar.push(DEL)
            i -= 1
            continue
        if D[j - 1, i] == g:
            cigar.push(INS)
            j -= 1
            continue

        _raise_trace_error(profile, pattern, wtext, j, i, g)

    if g != 0:
        raise TraceError(f"remaining cost after trace must be 0, got {g}")

    cigar.reverse()
    return Match(
        pattern_idx=0,
        text_idx=0,
        cost=total_cost,
        text_start=offset + i,
        text_end=offset + wlen,
        pattern_start=pattern_start,
        pattern_end=pattern_end,
        strand=Strand.FWD,
        cigar=cigar,
    )


def _raise_trace_error(profile, pattern, wtext, j, i, g):
    pat_ch = int(pattern[j - 1])
    if not profile.valid_seq(as_bytes_array(bytes([pat_ch]))):
        raise TraceError(
            f"trace failed: pattern contains non-{profile.name} character "
            f"{chr(pat_ch)!r} at position {j - 1} "
            f"(use the Iupac profile instead of Dna)"
        )
    if i > 0:
        txt_ch = int(wtext[i - 1])
        if not profile.valid_seq(as_bytes_array(bytes([txt_ch]))):
            raise TraceError(
                f"trace failed: text contains non-{profile.name} character "
                f"{chr(txt_ch)!r} at position {i - 1} "
                f"(use the Iupac profile instead of Dna)"
            )
    raise TraceError(f"trace failed: no ancestor of ({j}, {i}) at distance {g + 1}")
