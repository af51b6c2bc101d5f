"""The batched multi-pattern engine in PyTorch: Q patterns x N texts.

Port of ``sassy_tpu/ops/batch.py``. Texts are cut into pieces (whole short
texts, or word-aligned, halo-overlapped segments of long ones:
``_plan_pieces``); the pieces of all texts form the tile axis of one scan.
A strand's texts are uploaded once and packed into bit-planes on the
device (the reverse strand is derived there from the forward bytes; with
overhang each text is followed by its 'N' overshoot positions); each
dispatch chunk gathers its piece windows, NW = W + 1 words (one word of
right context past the owned range), from those planes.

Patterns are grouped by row bucket and overhang steps. A group whose
overshoot spans at most three words (always, without overhang) takes the
word-level path: the q2meta kernel (``myers_cuda.scan_q_meta``), the
cross-piece state chain and ``minima.select_words_tiles_q``. A longer
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

``candidates_many_async`` hands that device work to one dispatch thread
and returns at once: each chunk's ``torch.nonzero`` makes the host wait
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

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, fields

import numpy as np
import torch

from .. import semantics
from ..profiles import Profile, as_bytes_array
from . import minima, myers_cuda, plan
from .bitpack import WORD_BITS
from .minima import FULL, i32
from .myers_torch import pack, state_from_numpy
from .plan import _bucket_words, _masks_pure_np, cdiv, pattern_inputs_np

__all__ = ["BatchEngine", "TextSet", "DISPATCH_BYTES", "W_MAX_WORDS"]

#: Kernel output bytes one dispatch may write (vp, vm, cost and, at the
#: word level, meta: 12 or 16 bytes per pattern and window word): 4 GiB of
#: the H100's 80 GB, so the selection's temporaries and both strands'
#: planes fit beside it.
DISPATCH_BYTES = 4 << 30

#: Widest piece window in words (the JAX package's ``w_max_words``).
W_MAX_WORDS = 1 << 13

#: Bytes the reverse-strand gather indexes per pass (int64 indices: 128 MiB).
_REV_CHUNK = 1 << 24

_WORKER: ThreadPoolExecutor | None = None
_WORKER_LOCK = threading.Lock()


def _worker() -> ThreadPoolExecutor:
    """The one dispatch thread: dispatches run in the order submitted, one
    at a time, so a text set's caches are touched by one thread at once."""
    global _WORKER
    with _WORKER_LOCK:
        if _WORKER is None:
            _WORKER = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="sassy_tpu_torch-dispatch")
        return _WORKER


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
                 n_patterns: int) -> int:
    """Piece width in chars for one group: small enough that the pieces
    times the patterns fill the card (one thread per pair, the single
    path's ``plan.H100_TARGET_TILES``), wide enough to amortize the halo
    re-scan (>= 4 halos), at most the longest text with its overshoot."""
    tiles = cdiv(plan.H100_TARGET_TILES, n_patterns)
    target = max(4 * halo, cdiv(sum(lens) + steps * len(lens), tiles),
                 4 * WORD_BITS)
    w_cap = min(
        _bucket_words(max(cdiv(max(lens) + steps, WORD_BITS), 1)),
        _bucket_words(cdiv(target, WORD_BITS)),
        W_MAX_WORDS,
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
    word0: torch.Tensor  # int64, flat plane word of the piece start
    words_left: torch.Tensor  # int64, text words from the piece start

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


class TextSet:
    """A batch of texts on one device: piece plans per (halo, piece width,
    overhang steps) and bit-planes per (profile, strand, steps), reusable
    across patterns and k.

    The planes of a strand are one flat (P, GW + 1) array: text t owns
    words [wofs[t], wofs[t] + ceil((n_t + steps) / 32)), 'N' (every plane
    bit set) at its ``steps`` overshoot positions and zero past them; the
    last word is all-zero, the one that window words past a text end
    read."""

    def __init__(self, texts, device="cpu"):
        self.texts = [as_bytes_array(t) for t in texts]
        self.lens = [len(t) for t in self.texts]
        self.device = torch.device(device)
        n = np.asarray(self.lens, np.int64)
        self._nw = -(-n // WORD_BITS)
        self._wofs = np.concatenate([[0], np.cumsum(self._nw)]).astype(np.int64)
        self._plans: dict = {}
        self._planes: dict = {}
        self._fwd_bytes = None

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
            pieces = _plan_pieces(self.lens, steps, w_chars, halo)
            col = lambda f: np.array([getattr(p, f) for p in pieces],  # noqa: E731
                                     np.int64)
            tidx = col("text_idx")
            wstart = col("start_char") // WORD_BITS
            nw, wofs = self.layout(steps)
            dev = self.device
            i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)  # noqa: E731
            i64 = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            got = PiecePlan(
                w_chars=w_chars,
                steps=steps,
                true_start=torch.from_numpy(col("true_start") != 0).to(dev),
                valid_from=i32(col("valid_from")),
                valid_to=i32(col("valid_to")),
                islast_at=i32(col("islast_at")),
                text_end=i64(col("text_end")),
                start_char=i64(col("start_char")),
                text_idx=i64(tidx),
                word0=i64(wofs[tidx] + wstart),
                words_left=i64(nw[tidx] - wstart),
            )
            self._plans[key] = got
        return got

    def _bytes(self) -> torch.Tensor:
        """The texts' bytes on the device, text t at byte 32 * wofs[t]
        (one host buffer, one upload; cached for the reverse strand)."""
        if self._fwd_bytes is None:
            buf = np.zeros(WORD_BITS * (self.words() + 1), np.uint8)
            for t, w in zip(self.texts, self._wofs.tolist()):
                buf[WORD_BITS * w : WORD_BITS * w + len(t)] = t
            self._fwd_bytes = torch.from_numpy(buf).to(self.device)
        return self._fwd_bytes

    def _rev_bytes(self) -> torch.Tensor:
        """The reversed texts in the same slots, gathered on the device
        from the forward bytes: byte base_t + i = text t's n_t - 1 - i."""
        fwd = self._bytes()
        dev = self.device
        n_all = self.words() + 1
        # the zero word is an empty text of its own
        n = torch.tensor(self.lens + [0], dtype=torch.int64, device=dev)
        base = torch.from_numpy(self._wofs * WORD_BITS).to(dev)
        tid = torch.repeat_interleave(
            torch.arange(len(self.lens) + 1, device=dev),
            torch.from_numpy(np.append(self._nw, 1)).to(dev),
            output_size=n_all,
        )
        out = torch.empty_like(fwd)
        for p0 in range(0, fwd.numel(), _REV_CHUNK):
            p = torch.arange(p0, min(fwd.numel(), p0 + _REV_CHUNK),
                             dtype=torch.int64, device=dev)
            t = tid[p // WORD_BITS]
            r = p - base[t]
            src = (base[t] + n[t] - 1 - r).clamp(min=0)
            out[p0 : p0 + p.numel()] = torch.where(r < n[t], fwd[src], 0)
        return out

    def planes(self, profile: Profile, reverse: bool,
               steps: int = 0) -> torch.Tensor:
        """(P[+1], GW + 1) int32 bit-planes of the (reversed) texts, each
        followed by ``steps`` 'N' positions."""
        key = (profile.name, getattr(profile, "case_sensitive", None), reverse,
               steps)
        got = self._planes.get(key)
        if got is None and steps:
            got = self._with_overshoot(self.planes(profile, reverse), steps)
            self._planes[key] = got
        if got is None:
            buf = self._rev_bytes() if reverse else self._bytes()
            gw = self.words() + 1
            got = pack(
                buf, gw, 0, profile.planes, profile.eq_mode == "ascii",
                profile.pack_mode, profile.pack_shift, profile.pack_mask,
                tuple(profile.pack_plane_masks), profile.pack_fold_case,
            )
            # pad bytes encode to nonzero codes: zero each text's positions
            # past its end in its last word, and the zero word
            n = np.asarray(self.lens, np.int64)
            part = np.nonzero(n % WORD_BITS)[0]
            if len(part):
                last = torch.from_numpy(self._wofs[part] + self._nw[part] - 1)
                keep = (1 << (n[part] % WORD_BITS)) - 1
                keep = torch.from_numpy(keep.astype(np.uint32).view(np.int32))
                last, keep = last.to(self.device), keep.to(self.device)
                got[:, last] &= keep
            got[:, -1] = 0
            self._planes[key] = got
        return got

    def _with_overshoot(self, planes0: torch.Tensor,
                        steps: int) -> torch.Tensor:
        """The steps-0 planes regathered into the ``steps`` layout, with
        bits [n_t, n_t + steps) of each text set in every plane: the 'N'
        (matches everything) overhang padding of the reference's host
        packing (``_pack_pieces_np``), applied on the device."""
        dev = self.device
        nw, wofs = self.layout(steps)
        zero0 = self.words()
        # word j of text t in the new layout: the old word, or zero
        tid = torch.repeat_interleave(
            torch.arange(len(self.lens), device=dev),
            torch.from_numpy(nw).to(dev), output_size=int(wofs[-1]))
        j = torch.arange(int(wofs[-1]), device=dev) - torch.from_numpy(
            wofs[:-1]).to(dev)[tid]
        old = torch.from_numpy(self._nw).to(dev)[tid]
        src = torch.where(j < old, torch.from_numpy(self._wofs[:-1]).to(
            dev)[tid] + j, zero0)
        out = planes0[:, torch.cat([src, src.new_full((1,), zero0)])]
        # the overlay: <= cdiv(steps, 32) + 1 words per text
        n = torch.tensor(self.lens, dtype=torch.int64, device=dev)[:, None]
        w = n // WORD_BITS + torch.arange(cdiv(steps, WORD_BITS) + 1,
                                          device=dev)[None, :]

        def below(x):  # mask of word bits below text position x
            b = (x - w * WORD_BITS).clamp(0, WORD_BITS)
            return torch.where(b >= WORD_BITS, FULL, (1 << b) - 1)

        mask = below(n + steps) ^ below(n)
        inside = w < torch.from_numpy(nw).to(dev)[:, None]
        gidx = torch.where(inside, torch.from_numpy(wofs[:-1]).to(dev)[:, None]
                           + w, int(wofs[-1]))
        mask = torch.where(inside, mask, 0)
        out[:, gidx.reshape(-1)] |= i32(mask.reshape(-1))
        return out

    def windows(self, profile: Profile, pp: PiecePlan, reverse: bool,
                t0: int, t1: int) -> torch.Tensor:
        """(NW, P, t1 - t0) int32 windows of pieces t0..t1: piece words
        [start, start + NW) of its text, the zero word past the text end."""
        planes = self.planes(profile, reverse, pp.steps)
        j = torch.arange(pp.NW, dtype=torch.int64, device=self.device)[:, None]
        idx = torch.where(j < pp.words_left[None, t0:t1],
                          pp.word0[None, t0:t1] + j, self.words(pp.steps))
        return planes[:, idx].permute(1, 0, 2).contiguous()


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


class BatchEngine:
    """Cartesian-product candidate engine: Q patterns x N texts, batched.

    ``candidates_many`` returns ``out[q][t] = [(end_pos, cost), ...]`` with
    results identical to the single-(pattern, text) engine. On a CUDA
    device the scans are the q2meta and q2 kernels; on the CPU, their
    plain versions.
    """

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

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
            pm, pad, hi = state_from_numpy(
                *(np.stack([per[q][i] for q in qidx]) for i in range(3)),
                device=self.device,
            )
            scal = torch.tensor(
                [[len(pattern_codes[q]) for q in qidx],
                 [per[q][3] for q in qidx]],
                dtype=torch.int32, device=self.device,
            )
            out.append(_Group(
                qidx=torch.tensor(qidx, dtype=torch.int64, device=self.device),
                pmasks=pm, is_pad=pad, h_init=hi, m_real=scal[0],
                boundary_m=scal[1], eq_mode=eq_mode, halo=M + k,
                w_chars=_piece_width(ts.lens, steps, M + k, len(qidx)),
                steps=steps, alpha=alpha,
                n_prev=(cdiv(steps, WORD_BITS) + 1 if alpha is not None
                        else 0),
                hier_s=self._hier_rows(
                    min(len(pattern_codes[q]) for q in qidx), M, k, alpha),
            ))
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
        per_pair = (16 if g.fast else 12) * pp.NW
        q_chunk = max(1, min(g.Q, DISPATCH_BYTES // per_pair))
        t_chunk = max(1, DISPATCH_BYTES // (q_chunk * per_pair))
        for q0 in range(0, g.Q, q_chunk):
            for t0 in range(0, pp.T, t_chunk):
                yield q0, min(g.Q, q0 + q_chunk), t0, min(pp.T, t0 + t_chunk)

    @staticmethod
    def select_ranges(g: _Group, pp: PiecePlan, n_q: int, t0: int, t1: int):
        """The tile ranges, in order, that the selection of the chunk of
        ``n_q`` patterns over tiles t0..t1 runs over: the whole chunk on
        the word-level path (only screened words expand); sub-ranges of at
        most ``minima.POSITIONS_PER_CHUNK`` expanded (pattern, position)
        pairs on the position-level path, which bound its temporaries."""
        step = t1 - t0
        if not g.fast:
            step = max(1, minima.POSITIONS_PER_CHUNK
                       // (n_q * pp.NW * WORD_BITS))
        for s0 in range(t0, t1, step):
            yield s0, min(t1, s0 + step)

    @staticmethod
    def scan(win, g: _Group, pp: PiecePlan, q0, q1, t0, t1, k: int):
        """The kernel over one chunk's windows: word level, q2meta's (vp,
        vm, cost, meta) each (q1 - q0, NW, t1 - t0) and final (q1 - q0,
        t1 - t0); position level, q2's (vp, vm, cost)."""
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
        return torch.nonzero(((meta & 1) != 0).any(dim=1).any(dim=0)).view(-1)

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
        if g.fast:
            vp, vm, cost, meta, final = outs
        else:
            vp, vm, cost = outs
            final = minima.last_delta_codes(vp, vm, vf, vt)
        if all_minima:
            state0 = torch.zeros_like(final)
        else:
            # the previous chunk's state enters as a virtual tile before
            # this chunk's first, and a virtual tile after its last reads
            # the state carried on
            edge = torch.zeros(1, dtype=torch.bool, device=final.device)
            st = minima.tile_state_chain_codes(
                torch.cat([carry, final, torch.zeros_like(carry)], 1),
                torch.cat([edge, pp.true_start[t0:t1], edge]),
            )
            state0 = st[:, 1:-1]
            carry = torch.where(st[:, -1:] == 1, 3, 0).to(torch.int32)
        tend = pp.text_end[t0:t1]
        if g.fast:
            cols = minima.select_words_tiles_q(
                vp, vm, cost, meta, vf, vt, pp.islast_at[t0:t1],
                pp.start_char[t0:t1], k, state0, all_minima,
                tend if g.n_prev else None, g.alpha, g.n_prev,
            )
        else:
            q1 = q0 + vp.shape[0]
            boundary0 = torch.where(pp.true_start[None, t0:t1],
                                    g.boundary_m[q0:q1, None],
                                    g.m_real[q0:q1, None])
            cols = minima.select_candidates_tiles(
                vp, vm, cost, boundary0, tend, vf, vt, pp.islast_at[t0:t1],
                pp.start_char[t0:t1], k, g.alpha, state0, all_minima,
            )
        cols[0] = g.qidx[q0 + cols[0]]
        cols[1] = pp.text_idx[t0 + cols[1]]
        return cols, carry

    def dispatch(self, profile: Profile, ts: TextSet, g: _Group, k: int,
                 all_minima: bool, reverse: bool) -> list[torch.Tensor]:
        """Scan and select every chunk of one group on the current stream;
        returns the chunks' device columns."""
        pp = ts.piece_plan(g.halo, g.w_chars, g.steps)
        found = []
        carry = None
        for q0, q1, t0, t1 in self.chunks(g, pp):
            if t0 == 0:
                carry = torch.zeros((q1 - q0, 1), dtype=torch.int32,
                                    device=self.device)
            win = ts.windows(profile, pp, reverse, t0, t1)
            saved = ((q1 - q0) * (g.pmasks.shape[1] - g.hier_s) * pp.NW
                     * (t1 - t0))
            if g.hier_s and saved >= plan.HIER_MIN_SAVED_PAIRS:
                cols, carry = self._scan_flagged(win, g, pp, q0, q1, t0, t1,
                                                 k, all_minima, carry)
                if cols is not None:
                    found.append(cols)
                continue
            outs = self.scan(win, g, pp, q0, q1, t0, t1, k)
            del win
            for s0, s1 in self.select_ranges(g, pp, q1 - q0, t0, t1):
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
        first, last = ids[[0, -1]].tolist()
        if first != 0:
            carry = torch.zeros_like(carry)
        sub = pp.take(t0 + ids)
        outs = self.scan(win[:, :, ids].contiguous(), g, sub, q0, q1, 0,
                         sub.T, k)
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
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def run() -> np.ndarray:
            found: list[torch.Tensor] = []
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                if Q and NT:
                    for g in self.groups(profile, pattern_codes, ts, k,
                                         alpha, max_overhang):
                        found += self.dispatch(profile, ts, g, k, all_minima,
                                               reverse)
                return _fetch(found)

        job = _worker().submit(run)
        return lambda: _decode(job.result(), Q, NT, _flat)


def _fetch(found: list[torch.Tensor]) -> np.ndarray:
    """The chunks' device columns -> one (4, N) int64 host array, in one
    copy."""
    if not found:
        return np.zeros((4, 0), np.int64)
    return torch.cat(found, 1).cpu().numpy()


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
