"""Word-level candidate selection in PyTorch.

Port of the no-overhang meta path of ``sassy_tpu/ops/minima.py``: the
per-word screen and decreasing-state metadata (``meta_from_words``, the
plain version of what the scan kernel computes in place), the cross-tile
state chain (``tile_state_chain_codes``) and the selection of
rightmost-local-minimum end positions (``select_words_tiles``).

The TPU version compacts screened words in 1024-word blocks into
fixed-size ``cap`` buffers and retries with larger buffers on overflow,
because scatters are slow there. Here ``torch.nonzero`` compacts exactly,
and the result leaves the device in one copy.

Bit words arrive as int32 tensors holding uint32 bit patterns. torch has
no uint32 arithmetic to speak of (``>>`` on int32 is arithmetic, and there
is no popcount or clz), so the functions below widen them to int64 values
in [0, 2^32) with :func:`u32`.
"""

from __future__ import annotations

import torch

__all__ = [
    "u32",
    "i32",
    "word_min_prefix",
    "meta_from_words",
    "tile_state_chain_codes",
    "select_words_tiles",
]

WB = 32
FULL = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & FULL


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _smear(x: torch.Tensor) -> torch.Tensor:
    """Set every bit below the highest set bit (0 stays 0)."""
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> s)
    return x


def _last_delta_up(vp_o: torch.Tensor, vm_o: torch.Tensor) -> torch.Tensor:
    """True where the highest set bit of ``vp_o`` lies above that of
    ``vm_o`` (the reference's ``31 - clz`` comparison; -1 for zero)."""
    return vp_o > _smear(vm_o)


def _word_min_prefix64(vp: torch.Tensor, vm: torch.Tensor) -> torch.Tensor:
    s = torch.zeros_like(vp)
    mn = None
    for i in range(WB):
        s = s + ((vp >> i) & 1) - ((vm >> i) & 1)
        mn = s if mn is None else torch.minimum(mn, s)
    return mn


def word_min_prefix(vp: torch.Tensor, vm: torch.Tensor) -> torch.Tensor:
    """Exact min over i = 1..32 of the prefix sums of per-bit deltas
    (vp bit = +1, vm bit = -1), as int32."""
    return _word_min_prefix64(u32(vp), u32(vm)).to(torch.int32)


def _owned_delta_masks(widx, valid_from, valid_to):
    """int64 masks keeping delta bit j of word w iff its position
    ``w*32 + j + 1`` lies in the owned range (valid_from, valid_to]."""
    lo = (valid_from - widx * WB).clamp(0, WB)
    hi = (valid_to - widx * WB).clamp(0, WB)
    full = torch.full_like(lo, FULL)
    m_lo = torch.where(lo >= WB, 0, (full << lo) & FULL)
    m_hi = torch.where(hi >= WB, FULL, ~(full << hi) & FULL)
    return m_lo & m_hi


def meta_from_words(vp_w, vm_w, cost_w, valid_from, valid_to, k):
    """Per-word selection metadata from the scan outputs, bit-compatible
    with the scan kernel: ``meta`` (NW, T) int32, bit 0 = the word is owned
    and its exact min cost is <= k, bits 1-2 = the decreasing-state code at
    word start from owned deltas earlier in the tile (0 none, 2 last -1,
    3 last +1); ``final`` (T,) int32, the code after the last word."""
    NW, T = vp_w.shape
    dev = vp_w.device
    widx = torch.arange(NW, dtype=torch.int64, device=dev).view(NW, 1)
    wlo = widx * WB + 1
    whi = wlo + WB - 1
    vf = valid_from.to(torch.int64).view(1, T)
    vt = valid_to.to(torch.int64).view(1, T)
    vp = u32(vp_w)
    vm = u32(vm_w)

    first_owns_0 = (widx == 0) & (vf < 0)
    mp = _word_min_prefix64(vp, vm)
    # word 0 of a tile that owns position 0 also screens the tile's
    # boundary candidate (position 0, cost = the word-start cost)
    mp = torch.where(first_owns_0, torch.clamp(mp, max=0), mp)
    lb = cost_w.to(torch.int64) + mp
    wvalid = (whi > vf) & ((wlo <= vt) | first_owns_0)
    screen = wvalid & (lb <= k)

    omask = _owned_delta_masks(widx, vf, vt)
    vp_o = vp & omask
    vm_o = vm & omask
    has = (vp_o | vm_o) != 0
    s_w = _last_delta_up(vp_o, vm_o).to(torch.int64)
    # code at word START = the last present code of earlier words: put the
    # word index in the high bits for cummax, then strip it
    enc = torch.where(has, ((widx + 1) << 2) | (2 | s_w), 0)
    cm = torch.cummax(enc, dim=0).values
    prior = torch.cat([torch.zeros_like(cm[:1]), cm[:-1]], dim=0)
    meta = screen.to(torch.int64) | ((prior & 3) << 1)
    return meta.to(torch.int32), (cm[-1] & 3).to(torch.int32)


def tile_state_chain_codes(tl, is_start):
    """Cross-tile decreasing-state seeds from per-tile last-owned-delta
    codes (``tl`` (T,): 0 none, 2|sign otherwise, the kernel's ``final``),
    combined by an exclusive cummax in tile order and reset at tiles that
    own a text start (``is_start`` (T,) bool). Returns (T,) int32 in
    {0, 1}: 1 = the last delta before this tile's owned range was +1."""
    T = tl.shape[-1]
    t_ids = torch.arange(T, dtype=torch.int64, device=tl.device)
    tl = tl.to(torch.int64)
    tcode = torch.where(tl > 0, 2 * (t_ids + 2) + (tl & 1), 0)
    cm = torch.cummax(tcode, dim=-1).values
    ld = torch.cat([torch.zeros_like(cm[..., :1]), cm[..., :-1]], dim=-1)
    scode = torch.where(is_start, t_ids + 2, 0)
    ls = torch.cummax(scode, dim=-1).values
    state0 = torch.where((ld > 0) & ((ld >> 1) >= ls), ld & 1, 0)
    return state0.to(torch.int32)


def select_words_tiles(vp_w, vm_w, cost_w, meta, valid_from, valid_to,
                       islast_at, pos_base, k, state0, all_minima: bool):
    """Word-level candidate selection (no overhang).

    vp_w/vm_w/cost_w/meta: (NW, T) int32 scan outputs; valid_from/valid_to:
    (T,) window-local owned range (valid_from -1 = the tile owns position
    0); islast_at: (T,) window-local last text position (-1 = none);
    pos_base: (T,) int64 absolute position of window position 0; state0:
    (T,) cross-tile state seeds.

    Only screened words are expanded to their 33 positions (the word start
    stands for the tile's boundary candidate). Returns a (2, N) int64
    tensor on the device, [end positions; costs], in (word, tile,
    position) order.
    """
    NW, T = vp_w.shape
    F = NW * T
    dev = vp_w.device
    fidx = torch.nonzero((meta.reshape(-1) & 1) != 0).reshape(-1)
    g_w = fidx // T
    g_tile = fidx % T
    g_vp = u32(vp_w.reshape(-1)[fidx])
    g_vm = u32(vm_w.reshape(-1)[fidx])
    g_cost = cost_w.reshape(-1)[fidx].to(torch.int64)
    g_vfrom = valid_from[g_tile].to(torch.int64)
    g_vto = valid_to[g_tile].to(torch.int64)

    bit = torch.arange(WB, dtype=torch.int64, device=dev)
    delta32 = ((g_vp[:, None] >> bit) & 1) - ((g_vm[:, None] >> bit) & 1)
    lpos = g_w[:, None] * WB + torch.arange(WB + 1, device=dev)[None, :]
    delta = torch.cat([torch.zeros_like(delta32[:, :1]), delta32], dim=1)
    c = g_cost[:, None] + torch.cumsum(delta, dim=1)
    valid = (lpos > g_vfrom[:, None]) & (lpos <= g_vto[:, None])
    # column 0 only stands for the tile boundary position
    valid[:, 0] = (g_w == 0) & (g_vfrom < 0)

    if all_minima:
        mask = valid & (c <= k)
    else:
        # decreasing-state at word start: the word's own code if an owned
        # delta came earlier in the tile, else the cross-tile seed
        code = (meta.reshape(-1)[fidx].to(torch.int64) >> 1) & 3
        g_din = torch.where(code > 0, (code & 1) == 0, state0[g_tile] == 0)
        # first delta of the NEXT word (an artificial +1 past the window)
        f2 = torch.clamp(fidx + T, max=F - 1)
        nf = (u32(vp_w.reshape(-1)[f2]) & 1) - (u32(vm_w.reshape(-1)[f2]) & 1)
        g_next = torch.where(g_w + 1 < NW, nf, 1)

        enc = torch.where(
            delta > 0, 2 * lpos + 1, torch.where(delta < 0, 2 * lpos, 0)
        )
        # halo positions inside a straddling word are restart artifacts:
        # they must not feed the decreasing-state
        enc = torch.where(lpos > g_vfrom[:, None], enc, 0)
        seed = torch.where(g_din, 0, 1)[:, None]
        st = torch.cummax(torch.cat([seed, enc], dim=1), dim=1).values[:, 1:]
        d = (st == 0) | ((st & 1) == 0)
        delta_next = torch.cat([delta[:, 1:], g_next[:, None]], dim=1)
        g_ilast = islast_at[g_tile].to(torch.int64)
        next_gt = (delta_next >= 1) | (lpos == g_ilast[:, None])
        mask = valid & (c <= k) & next_gt & d

    pos = pos_base[g_tile][:, None] + lpos
    return torch.stack([pos[mask], c[mask]])
