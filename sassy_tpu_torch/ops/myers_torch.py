"""The single-pattern search pipeline in PyTorch.

Port of the no-overhang fast path of ``sassy_tpu/ops/myers_xla.py``: text
bytes -> P bit-planes of 32-position words (``pack``) -> halo-tiled
windows in the (NW, P, T) layout (``build_windows``) -> the transposed
Myers'99 word scan with selection metadata (the CUDA kernel of
``myers_cuda.scan_meta``; ``scan_core`` is its plain version) -> the
cross-tile state chain and word-level selection (``minima``) -> a sorted
host list of (end position, cost).

Device tensors hold uint32 bit words as int32; the plain versions compute
on int64 values masked to 32 bits (see ``minima.u32``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sassy_tpu.ops.bitpack import WORD_BITS
from sassy_tpu.profiles import Profile, as_bytes_array

from . import minima, myers_cuda
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
    """The bit-parallel word scan (plain PyTorch).

    windows: (NW, P, T) int32, word w of plane p for tile t; pmasks (M, P)
    ((M, P - 1) for ascii: the validity plane has no mask), is_pad (M,),
    hp0/hm0 (M, T) int32 bit patterns; cost0 (T,) int32.
    ``eq_mode``: "iupac" (eq = pad | OR_p plane & mask), "pure" (eq = pad |
    the row's one plane) or "ascii" (byte equality gated by the validity
    plane). Returns (vp, vm, cost), each (NW, T) int32: the last row's
    vertical delta words and its cost at the start of each word.
    """
    NW, P, T = windows.shape
    M = pmasks.shape[0]
    pm = u32(pmasks).tolist()
    pad = u32(is_pad).tolist()
    pidx = pure_plane_index(pmasks).tolist() if eq_mode == "pure" else None
    hp = u32(hp0)
    hm = u32(hm0)
    cost = cost0.to(torch.int64)
    vp_out = torch.empty((NW, T), dtype=torch.int32, device=windows.device)
    vm_out = torch.empty_like(vp_out)
    cost_out = torch.empty_like(vp_out)
    for w in range(NW):
        x = u32(windows[w])
        vp = torch.zeros_like(cost)
        vm = torch.zeros_like(cost)
        for j in range(M):
            if eq_mode == "pure":
                eq = x[pidx[j]] | pad[j]
            elif eq_mode == "iupac":
                eq = torch.full_like(cost, pad[j])
                for p in range(P):
                    if pm[j][p]:
                        eq = eq | (x[p] & pm[j][p])
            else:
                acc = torch.zeros_like(cost)
                for p in range(P - 1):
                    acc = acc | (x[p] ^ pm[j][p])
                eq = ((~acc & FULL) & x[P - 1]) | pad[j]
            hp_j = hp[j]
            hm_j = hm[j]
            # Myers step (reference bitpacking.rs:63-85), 32-bit words
            vx = eq | vm
            eqh = eq | hm_j
            hx = ((((eqh & vp) + vp) & FULL) ^ vp) | eqh
            hp_o = vm | (~(hx | vp) & FULL)
            hm_o = vp & hx
            hp_sh = ((hp_o << 1) & FULL) | hp_j
            hm_sh = ((hm_o << 1) & FULL) | hm_j
            # hp_j/hm_j are views of these rows: overwrite them last
            hp[j] = hp_o >> 31
            hm[j] = hm_o >> 31
            vp = hm_sh | (~(vx | hp_sh) & FULL)
            vm = hp_sh & vx
        vp_out[w] = i32(vp)
        vm_out[w] = i32(vm)
        cost_out[w] = cost.to(torch.int32)
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
    and k, with its windows cached per tile plan."""

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

    def windows(self, T: int, W: int, halo: int) -> torch.Tensor:
        """(NW, P, T) windows for one tile plan; the last two plans stay
        cached (an entry is ~(1 + (halo+1)/W) x the planes' size)."""
        key = (T, W, halo)
        got = self._wins.get(key)
        if got is None:
            got = build_windows(self.planes, T, W, halo)
            while len(self._wins) >= 2:
                self._wins.pop(next(iter(self._wins)))
            self._wins[key] = got
        return got


@dataclass
class ScanInputs:
    """Everything one scan + selection needs, on the engine's device."""

    windows: torch.Tensor  # (NW, P, T) int32
    tile0: torch.Tensor  # (T,) bool: the tile owns the text start
    valid_from: torch.Tensor  # (T,) int32 window-local, -1 = owns position 0
    valid_to: torch.Tensor  # (T,) int32 window-local last owned position
    islast: torch.Tensor  # (T,) int32 window-local text end, -1 = elsewhere
    offset: torch.Tensor  # (T,) int64 absolute position of window position 0
    pmasks: torch.Tensor  # (M, P) int32
    is_pad: torch.Tensor  # (M,) int32
    h_init: torch.Tensor  # (M,) int32
    m_real: int
    boundary_m: int
    k: int
    eq_mode: str  # "iupac", "pure" or "ascii"
    all_minima: bool


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
                     k: int, all_minima: bool = False) -> ScanInputs:
        prep = (text if isinstance(text, PreparedText)
                else self.prepare(profile, text))
        m = len(pattern_codes)
        max_pos = prep.n
        if max_pos >= (1 << 31) - 1:
            raise ValueError(
                f"text of {prep.n} positions exceeds the single-pattern "
                "engine's int32 position space"
            )
        halo = halo_words(_bucket_rows(m), k)
        words_needed = max(1, cdiv(max_pos, WORD_BITS))
        T, W, halo = plan_tiles(words_needed, halo)
        pmasks, is_pad, h_init, boundary_m = pattern_inputs_np(
            profile, pattern_codes, None, None
        )
        eq_mode = profile.eq_mode
        if eq_mode == "iupac" and _masks_pure_np(pmasks, is_pad):
            # ACGT-pure pattern: one plane per row, on every device
            eq_mode = "pure"

        dev = self.device
        WB = WORD_BITS
        tile = torch.arange(T, dtype=torch.int64, device=dev)
        tile0 = tile == 0
        offset = torch.where(tile0, 0, tile * (W * WB) - halo * WB)
        vfrom = torch.where(tile0, -1, halo * WB)
        vto_raw = torch.where(tile0, W * WB, (halo + W) * WB)
        rel_last = max_pos - offset
        vto = torch.minimum(vto_raw, rel_last)
        islast = torch.where(
            (rel_last > vfrom) & (rel_last <= vto_raw), rel_last, -1
        )
        pm_t, pad_t, hinit_t = state_from_numpy(
            pmasks, is_pad, h_init, device=dev
        )
        return ScanInputs(
            windows=prep.windows(T, W, halo), tile0=tile0,
            valid_from=vfrom.to(torch.int32), valid_to=vto.to(torch.int32),
            islast=islast.to(torch.int32), offset=offset, pmasks=pm_t,
            is_pad=pad_t, h_init=hinit_t, m_real=m, boundary_m=boundary_m,
            k=k, eq_mode=eq_mode, all_minima=all_minima,
        )

    def scan(self, inp: ScanInputs):
        """(vp, vm, cost, meta) each (NW, T) and final (T,), int32."""
        return myers_cuda.scan_meta(
            inp.windows, inp.tile0, inp.valid_from, inp.valid_to, inp.pmasks,
            inp.is_pad, inp.h_init, inp.m_real, inp.boundary_m, inp.k,
            inp.eq_mode,
        )

    def select(self, inp: ScanInputs, outs) -> torch.Tensor:
        """(2, N) int64 [end positions; costs] on the device."""
        vp, vm, cost, meta, final = outs
        if inp.all_minima:
            state0 = torch.zeros_like(final)
        else:
            state0 = minima.tile_state_chain_codes(final, inp.tile0)
        return minima.select_words_tiles(
            vp, vm, cost, meta, inp.valid_from, inp.valid_to, inp.islast,
            inp.offset, inp.k, state0, inp.all_minima,
        )

    def candidates(self, profile: Profile, pattern_codes: np.ndarray, text,
                   k: int, alpha, max_overhang, all_minima: bool):
        """Sorted [(end position, cost)] of one pattern on one strand."""
        del max_overhang  # bounds the overhang, which needs alpha
        if alpha is not None:
            raise NotImplementedError(
                "overhang (alpha) is not ported yet: ROADMAP.md, Queue 1, "
                "'Overhang on the single path'"
            )
        inp = self.build_inputs(profile, pattern_codes, text, k, all_minima)
        pos, cost = self.select(inp, self.scan(inp)).cpu().tolist()
        return sorted(zip(pos, cost))
