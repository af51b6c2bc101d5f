"""The single-pattern search pipeline in PyTorch.

Port of ``sassy_tpu/ops/myers_xla.py``: text bytes -> P bit-planes of
32-position words (``pack``; with overhang, ``overlay_n_tail`` sets the
'N' positions past the text end) -> halo-tiled windows in the (NW, P, T)
layout (``build_windows``) -> the transposed Myers'99 word scan (the CUDA
kernels of ``myers_cuda``; ``scan_core`` is their plain version) ->
candidate selection (``minima``) -> a sorted host list of (end position,
cost).

Two paths, as in the reference engine:

- word level (no overhang, or an overshoot span of at most three words):
  the q1meta scan with selection metadata, the cross-tile state chain and
  ``minima.select_words_tiles``; with overhang one extra tail tile owns
  the overshoot span;
- position level (a longer overshoot span): the q1 scan and
  ``minima.select_candidates`` over every position.

Without overhang, a pattern with ``plan.suffix_rows`` > 0 whose suffix
scan saves at least ``plan.HIER_MIN_SAVED_PAIRS`` (row, word) pairs first
runs the hierarchical suffix prefilter: q1meta with the pattern's last rows flags the tiles that can
hold a match, and the word-level path runs on those tiles only.

Device tensors hold uint32 bit words as int32; the plain versions compute
on int64 values masked to 32 bits (see ``minima.u32``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import semantics
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
    "overlay_n_tail",
    "build_windows",
    "scan_core",
    "pure_plane_index",
    "PreparedText",
    "ScanInputs",
    "TorchEngine",
    "state_from_numpy",
]

#: Words packed per pass: the per-char expansion of a chunk takes
#: 4 bytes per char, so 2^20 words keep it at 128 MiB for any text size.
PACK_CHUNK_WORDS = 1 << 20


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
         pmasks: tuple, fold: bool) -> torch.Tensor:
    """(GW*32,) uint8 raw text, zero tail -> (P[+1], GW) int32 bit-planes
    of the engine codes: bit i of word w of plane p = bit p of the code of
    char 32*w + i. ``mode`` "table5": code bit p of byte b = bit
    ``(b >> shift) & mask`` of ``pmasks[p]``; "byte": the (case-folded with
    ``fold``) byte's own bits. Positions >= n = nw*32 + nb are zero; the
    optional validity plane marks positions < n. n arrives split in words
    and bits, as in the reference, so no position needs more than int32."""
    gw = text_u8.shape[0] // WORD_BITS
    dev = text_u8.device
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


def build_windows(planes: torch.Tensor, T: int, W: int, halo: int) -> torch.Tensor:
    """(P, GW) planes -> (NW, P, T) int32 windows, NW = W + halo + 1.

    Tile t's window is flat words [t*W - halo, t*W + W]: the halo of left
    context, its W owned words and one right-context word, so the minima
    lookahead at the tile's last owned position reads the true next delta.
    Words before 0 or at/after T*W read as 0 (cost only rises there). Tile
    0's window is the text head [0, NW): it owns the true start and needs
    no halo. Any halo width works, including halo > W.
    """
    P, gw = planes.shape
    NW = W + halo + 1
    TW = T * W
    own = min(TW, gw)
    # flat word f sits at ext[:, halo + f]; window word i of tile t is
    # ext[:, t*W + i]: an overlapping strided view, copied once
    ext = torch.zeros((P, halo + TW + W), dtype=planes.dtype,
                      device=planes.device)
    ext[:, halo : halo + own] = planes[:, :own]
    win = ext.as_strided((NW, P, T), (1, ext.stride(0), W)).contiguous()
    head = min(NW, gw)
    win[:head, :, 0] = planes[:, :head].T
    win[head:, :, 0] = 0
    return win


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


def _upload(text, device: torch.device) -> torch.Tensor:
    """Raw text bytes -> a uint8 tensor on ``device``."""
    if isinstance(text, torch.Tensor):
        return text.to(device=device, dtype=torch.uint8)
    a = as_bytes_array(text)
    if a.strides[0] < 0:
        # a reversed view (the reverse strand): upload the forward bytes
        # and reverse on the device instead of copying on the host
        return _upload(a[::-1], device).flip(0)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


class PreparedText:
    """Device-resident bit-planes of one text, reusable across patterns
    and k, with its windows cached per tile plan and overhang steps."""

    def __init__(self, profile: Profile, text, device):
        self.profile = profile
        self.device = torch.device(device)
        self.n = len(text)
        self.gw = _bucket_words(cdiv(self.n, WORD_BITS) + TAIL_RESERVE_WORDS)
        buf = torch.zeros(self.gw * WORD_BITS, dtype=torch.uint8,
                          device=self.device)
        buf[: self.n] = _upload(text, self.device)
        self.planes = pack(
            buf, self.n // WORD_BITS, self.n % WORD_BITS, profile.planes,
            profile.eq_mode == "ascii", profile.pack_mode, profile.pack_shift,
            profile.pack_mask, tuple(profile.pack_plane_masks),
            profile.pack_fold_case,
        )
        self._wins: dict = {}
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
                tail_word: int | None = None) -> torch.Tensor:
        """(NW, P, T) windows of ``planes_for(steps)`` for one tile plan;
        with ``tail_word``, the last tile's window is instead the NW words
        from that word on (the overhang tail tile). The last two plans
        stay cached (an entry is ~(1 + (halo+1)/W) x the planes' size)."""
        key = (steps, T, W, halo, tail_word)
        got = self._wins.get(key)
        if got is None:
            planes = self.planes_for(steps)
            got = build_windows(planes, T, W, halo)
            if tail_word is not None:
                hi = min(planes.shape[1], tail_word + W + halo + 1)
                got[:, :, T - 1] = 0
                got[: hi - tail_word, :, T - 1] = planes[:, tail_word:hi].T
            while len(self._wins) >= 2:
                self._wins.pop(next(iter(self._wins)))
            self._wins[key] = got
        return got


@dataclass
class ScanInputs:
    """Everything one scan + selection needs, on the engine's device."""

    windows: torch.Tensor  # (NW, P, T) int32
    tile0: torch.Tensor  # (T,) bool: the tile starts from the true boundary
    text_start: torch.Tensor  # (T,) bool: the tile owns the text start
    valid_from: torch.Tensor  # (T,) int32 window-local, -1 = owns position 0
    valid_to: torch.Tensor  # (T,) int32 window-local last owned position
    islast: torch.Tensor  # (T,) int32 window-local last position, -1 = none
    offset: torch.Tensor  # (T,) int64 absolute position of window position 0
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


class TorchEngine:
    """Single-pattern engine: device pack, windows, scan kernel and
    selection, then one host copy of the candidate list. On a CUDA device
    the scan is the hand-written kernel; on the CPU, its plain version."""

    name = "torch"

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    def prepare(self, profile: Profile, text) -> PreparedText:
        return PreparedText(profile, text, self.device)

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
        if alpha is not None and fast:
            # the tail tile restarts from the plain cost-j boundary, so it
            # re-scans the m + k chars before its owned overshoot span
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
        tile = torch.arange(T, dtype=torch.int64, device=dev)
        text_start = tile == 0
        offset = torch.where(text_start, 0, tile * (W * WB) - halo * WB)
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
            offset = torch.where(tail, s0, offset)
            vfrom = torch.where(tail, n - s0, vfrom)
            vto = torch.where(tail, max_pos - s0, vto)
            islast = torch.where(tail, max_pos - s0, islast)
            text_end = n - offset
        pm_t, pad_t, hinit_t = state_from_numpy(
            pmasks, is_pad, h_init, device=dev
        )
        return ScanInputs(
            windows=prep.windows(T, W, halo, steps, tail_word), tile0=tile0,
            text_start=text_start, valid_from=vfrom.to(torch.int32),
            valid_to=vto.to(torch.int32), islast=islast.to(torch.int32),
            offset=offset, pmasks=pm_t, is_pad=pad_t, h_init=hinit_t,
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
            inp, windows=inp.windows[:, :, ids].contiguous(),
            tile0=inp.tile0[ids], text_start=inp.text_start[ids],
            valid_from=inp.valid_from[ids], valid_to=inp.valid_to[ids],
            islast=inp.islast[ids], offset=inp.offset[ids], hier_s=0,
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
        vp, vm, cost, meta, final = outs
        if inp.all_minima:
            state0 = torch.zeros_like(final)
        else:
            # the chain resets at the text start only: the tail tile's
            # window may start at the boundary, but the text does not
            # restart there
            state0 = minima.tile_state_chain_codes(final, inp.text_start)
        return minima.select_words_tiles(
            vp, vm, cost, meta, inp.valid_from, inp.valid_to, inp.islast,
            inp.offset, inp.k, state0, inp.all_minima, inp.text_end,
            inp.alpha, inp.n_prev,
        )

    def candidates(self, profile: Profile, pattern_codes: np.ndarray, text,
                   k: int, alpha, max_overhang, all_minima: bool):
        """Sorted [(end position, cost)] of one pattern on one strand."""
        inp = self.build_inputs(profile, pattern_codes, text, k, alpha,
                                max_overhang, all_minima)
        if inp.hier_s:
            ids = self.flagged_tiles(inp)
            if ids.numel() == 0:
                return []
            inp = self.gather_tiles(inp, ids)
        pos, cost = self.select(inp, self.scan(inp)).cpu().tolist()
        return sorted(zip(pos, cost))
