"""The batched multi-pattern engine in PyTorch: Q patterns x N texts.

Port of the no-overhang fast path of ``sassy_tpu/ops/batch.py``. Texts are
cut into pieces (whole short texts, or word-aligned, halo-overlapped
segments of long ones: ``_plan_pieces``); the pieces of all texts form the
tile axis of one scan. A strand's texts are uploaded once and packed into
bit-planes on the device (the reverse strand is derived there from the
forward bytes); each dispatch chunk gathers its piece windows, NW = W + 1
words (one word of right context past the owned range), from those planes.
The q2meta kernel (``myers_cuda.scan_q_meta``) scans every (pattern,
piece) pair; the cross-piece state chain and
``minima.select_words_tiles_q`` turn its outputs into (pattern, text, end
position, cost) columns on the device, which leave it in one copy.

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
reproduce the numpy planner of the JAX package without its overhang
``steps`` and TPU ``pad_mult`` (that module imports the JAX engines, this
package must not); the tests hold them equal to the originals.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from sassy_tpu.ops.bitpack import WORD_BITS
from sassy_tpu.profiles import Profile, as_bytes_array

from . import minima, myers_cuda, plan
from .myers_torch import pack, state_from_numpy
from .plan import _bucket_words, _masks_pure_np, cdiv, pattern_inputs_np

__all__ = ["BatchEngine", "TextSet", "DISPATCH_BYTES", "W_MAX_WORDS"]

#: Kernel output bytes one dispatch may write (vp, vm, cost and meta: 16
#: bytes per pattern and window word): 4 GiB of the H100's 80 GB, so the
#: selection's temporaries and both strands' planes fit beside it.
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
    islast_at: int  # trailing-minimum position (-1 for non-final segments)
    true_start: bool


def _plan_pieces(lens: list[int], w_chars: int, halo: int) -> list[_Piece]:
    """Cut texts into pieces of <= w_chars positions each.

    Position space of text t is 1..n_t (+ the boundary position 0, owned by
    the true-start piece). A continuation piece re-scans ``halo`` chars
    before its owned range, from a word-aligned start.
    """
    pieces: list[_Piece] = []
    for t, total in enumerate(lens):
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
            last = o + own >= total
            pieces.append(
                _Piece(
                    text_idx=t,
                    start_char=start_char,
                    valid_from=vfrom,
                    valid_to=vfrom + own if not first else own,
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


def _pick_w_words(lens: list[int], halo: int, w_cap: int) -> int:
    """Piece-window width (words) minimizing total scanned words.

    The kernel scans every piece's full window, so a width that divides the
    text lengths poorly pads each text by up to w_chars - 1 chars. Evaluate
    the bucket lattice <= w_cap with an analytic piece-count model; ties
    prefer the widest window (fewest pieces)."""
    cands = _w_lattice(w_cap)
    if w_cap not in cands:
        cands.append(w_cap)
    ln = np.asarray(lens, np.int64)
    halo_a = halo + WORD_BITS - 1  # worst-case word-aligned halo re-scan
    best_w, best_cost = None, None
    for w in cands:
        wc = w * WORD_BITS
        if wc <= halo + WORD_BITS or wc <= halo_a + WORD_BITS:
            continue
        over = np.maximum(ln - wc, 0)
        cont = -(-over // (wc - halo_a))
        cost = int(np.sum(1 + cont)) * w
        if best_cost is None or cost < best_cost or (
            cost == best_cost and w > best_w
        ):
            best_w, best_cost = w, cost
    return best_w if best_w is not None else w_cap


def _piece_width(lens: list[int], halo: int, n_patterns: int) -> int:
    """Piece width in chars for one row bucket: small enough that the
    pieces times the patterns fill the card (one thread per pair, the
    single path's ``plan.H100_TARGET_TILES``), wide enough to amortize the
    halo re-scan (>= 4 halos), at most the longest text."""
    tiles = cdiv(plan.H100_TARGET_TILES, n_patterns)
    target = max(4 * halo, cdiv(sum(lens), tiles), 4 * WORD_BITS)
    w_cap = min(
        _bucket_words(max(cdiv(max(lens), WORD_BITS), 1)),
        _bucket_words(cdiv(target, WORD_BITS)),
        W_MAX_WORDS,
    )
    w_chars = _pick_w_words(lens, halo, w_cap) * WORD_BITS
    if w_chars <= halo + WORD_BITS:
        w_chars = _bucket_words(cdiv(halo + 4 * WORD_BITS, WORD_BITS)) * WORD_BITS
    return w_chars


@dataclass
class PiecePlan:
    """The pieces of one (halo, piece width) as device tables, (T,) each."""

    w_chars: int
    true_start: torch.Tensor  # bool
    valid_from: torch.Tensor  # int32, piece-local
    valid_to: torch.Tensor  # int32
    islast_at: torch.Tensor  # int32
    start_char: torch.Tensor  # int64, text-local position of piece position 0
    text_idx: torch.Tensor  # int64
    word0: torch.Tensor  # int64, flat plane word of the piece start
    words_left: torch.Tensor  # int64, text words from the piece start

    @property
    def T(self) -> int:
        return self.true_start.shape[0]

    @property
    def NW(self) -> int:
        return self.w_chars // WORD_BITS + 1


class TextSet:
    """A batch of texts on one device: piece plans per (halo, piece width)
    and bit-planes per (profile, strand), reusable across patterns and k.

    The planes of a strand are one flat (P, GW + 1) array: text t owns
    words [wofs[t], wofs[t] + ceil(n_t / 32)), zero past its end; the last
    word is all-zero, the one that window words past a text end read."""

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

    @property
    def words(self) -> int:
        """Plane words of all texts, the zero word excluded."""
        return int(self._wofs[-1])

    def piece_plan(self, halo: int, w_chars: int) -> PiecePlan:
        key = (halo, w_chars)
        got = self._plans.get(key)
        if got is None:
            pieces = _plan_pieces(self.lens, w_chars, halo)
            col = lambda f: np.array([getattr(p, f) for p in pieces],  # noqa: E731
                                     np.int64)
            tidx = col("text_idx")
            wstart = col("start_char") // WORD_BITS
            dev = self.device
            i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)  # noqa: E731
            i64 = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            got = PiecePlan(
                w_chars=w_chars,
                true_start=torch.from_numpy(col("true_start") != 0).to(dev),
                valid_from=i32(col("valid_from")),
                valid_to=i32(col("valid_to")),
                islast_at=i32(col("islast_at")),
                start_char=i64(col("start_char")),
                text_idx=i64(tidx),
                word0=i64(self._wofs[tidx] + wstart),
                words_left=i64(self._nw[tidx] - wstart),
            )
            self._plans[key] = got
        return got

    def _bytes(self) -> torch.Tensor:
        """The texts' bytes on the device, text t at byte 32 * wofs[t]
        (one host buffer, one upload; cached for the reverse strand)."""
        if self._fwd_bytes is None:
            buf = np.zeros(WORD_BITS * (self.words + 1), np.uint8)
            for t, w in zip(self.texts, self._wofs.tolist()):
                buf[WORD_BITS * w : WORD_BITS * w + len(t)] = t
            self._fwd_bytes = torch.from_numpy(buf).to(self.device)
        return self._fwd_bytes

    def _rev_bytes(self) -> torch.Tensor:
        """The reversed texts in the same slots, gathered on the device
        from the forward bytes: byte base_t + i = text t's n_t - 1 - i."""
        fwd = self._bytes()
        dev = self.device
        n_all = self.words + 1
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

    def planes(self, profile: Profile, reverse: bool) -> torch.Tensor:
        """(P[+1], GW + 1) int32 bit-planes of the (reversed) texts."""
        key = (profile.name, getattr(profile, "case_sensitive", None), reverse)
        got = self._planes.get(key)
        if got is None:
            buf = self._rev_bytes() if reverse else self._bytes()
            gw = self.words + 1
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

    def windows(self, profile: Profile, pp: PiecePlan, reverse: bool,
                t0: int, t1: int) -> torch.Tensor:
        """(NW, P, t1 - t0) int32 windows of pieces t0..t1: piece words
        [start, start + NW) of its text, the zero word past the text end."""
        planes = self.planes(profile, reverse)
        j = torch.arange(pp.NW, dtype=torch.int64, device=self.device)[:, None]
        idx = torch.where(j < pp.words_left[None, t0:t1],
                          pp.word0[None, t0:t1] + j, self.words)
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

    @property
    def Q(self) -> int:
        return self.qidx.shape[0]


class BatchEngine:
    """Cartesian-product candidate engine: Q patterns x N texts, batched.

    ``candidates_many`` returns ``out[q][t] = [(end_pos, cost), ...]`` with
    results identical to the single-(pattern, text) engine. On a CUDA
    device the scan is the q2meta kernel; on the CPU, its plain version.
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

    def groups(self, profile: Profile, pattern_codes, ts: TextSet,
               k: int) -> list[_Group]:
        """The patterns grouped by row bucket M, with their scan inputs on
        the device and their piece width."""
        per = [pattern_inputs_np(profile, c, None, None) for c in pattern_codes]
        by_m: dict[int, list[int]] = {}
        for qi, p in enumerate(per):
            by_m.setdefault(p[0].shape[0], []).append(qi)
        out = []
        for M, qidx in by_m.items():
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
                w_chars=_piece_width(ts.lens, M + k, len(qidx)),
            ))
        return out

    @staticmethod
    def chunks(g: _Group, pp: PiecePlan):
        """(q0, q1, t0, t1) dispatch chunks: kernel outputs of at most
        ``DISPATCH_BYTES`` each, whole patterns first. The tile chunks of
        one pattern range come in order, as the state chain needs."""
        per_pair = 16 * pp.NW  # output bytes per (pattern, piece)
        q_chunk = max(1, min(g.Q, DISPATCH_BYTES // per_pair))
        t_chunk = max(1, DISPATCH_BYTES // (q_chunk * per_pair))
        for q0 in range(0, g.Q, q_chunk):
            for t0 in range(0, pp.T, t_chunk):
                yield q0, min(g.Q, q0 + q_chunk), t0, min(pp.T, t0 + t_chunk)

    @staticmethod
    def scan(win, g: _Group, pp: PiecePlan, q0, q1, t0, t1, k: int):
        """The kernel over one chunk's windows: (vp, vm, cost, meta) each
        (q1 - q0, NW, t1 - t0) and final (q1 - q0, t1 - t0)."""
        return myers_cuda.scan_q_meta(
            win, pp.true_start[t0:t1], pp.valid_from[t0:t1],
            pp.valid_to[t0:t1], g.pmasks[q0:q1], g.is_pad[q0:q1],
            g.h_init[q0:q1], g.m_real[q0:q1], g.boundary_m[q0:q1], k,
            g.eq_mode,
        )

    @staticmethod
    def select(outs, g: _Group, pp: PiecePlan, q0, t0, t1, k: int,
               all_minima: bool, carry):
        """One chunk's candidates as (4, N) int64 device columns [pattern;
        text; end position; cost], and the state code carried into the
        next tile chunk. ``carry`` (Qc, 1) int32: the code after the
        previous tile chunk (0 at the first)."""
        vp, vm, cost, meta, final = outs
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
        cols = minima.select_words_tiles_q(
            vp, vm, cost, meta, pp.valid_from[t0:t1], pp.valid_to[t0:t1],
            pp.islast_at[t0:t1], pp.start_char[t0:t1], k, state0, all_minima,
        )
        cols[0] = g.qidx[q0 + cols[0]]
        cols[1] = pp.text_idx[t0 + cols[1]]
        return cols, carry

    def dispatch(self, profile: Profile, ts: TextSet, g: _Group, k: int,
                 all_minima: bool, reverse: bool) -> list[torch.Tensor]:
        """Scan and select every chunk of one group on the current stream;
        returns the chunks' device columns."""
        pp = ts.piece_plan(g.halo, g.w_chars)
        found = []
        carry = None
        for q0, q1, t0, t1 in self.chunks(g, pp):
            if t0 == 0:
                carry = torch.zeros((q1 - q0, 1), dtype=torch.int32,
                                    device=self.device)
            win = ts.windows(profile, pp, reverse, t0, t1)
            outs = self.scan(win, g, pp, q0, q1, t0, t1, k)
            cols, carry = self.select(outs, g, pp, q0, t0, t1, k, all_minima,
                                      carry)
            found.append(cols)
        return found

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
        del max_overhang  # bounds the overhang, which needs alpha
        if alpha is not None:
            raise NotImplementedError(
                "batched overhang (alpha) is not ported yet: ROADMAP.md, "
                "Queue 1, 'Batched overhang'"
            )
        ts = self.textset(texts)
        Q, NT = len(pattern_codes), len(ts.lens)
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def run() -> np.ndarray:
            found: list[torch.Tensor] = []
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                if Q and NT:
                    for g in self.groups(profile, pattern_codes, ts, k):
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
