"""Candidate selection in PyTorch.

Port of ``sassy_tpu/ops/minima.py``: the per-word screen and
decreasing-state metadata (``meta_from_words``, the plain version of what
the meta scan kernels compute in place), the cross-tile state chain
(``tile_state_chain_codes``, from the kernels' ``final`` codes or from
``last_delta_codes``), and the selection of rightmost-local-minimum end
positions:

- word level (``select_words_chained``, the state chained across the
  tiles from the scan's ``final`` codes and carried in and out, which all
  three engines call; ``select_words_tiles_q`` over Q patterns and
  ``select_words_tiles`` for one, each tile's state given): only screened
  words expand to positions; with overhang, a strip of the ``n_prev``
  preceding words makes the decreasing state exact over the overshoot
  costs;
- position level, for overhang searches whose overshoot spans more than
  four words: ``select_candidates`` over the flat positions of one text
  (the single engine), ``select_candidates_tiles`` per piece, and
  ``select_candidates_chained``, the pieces with their state chained
  across them and carried in and out (the batched engine).

Each selection is an entry point that runs its plain version
(``select_words_chained_plain``, ``select_words_tiles_q_plain``,
``select_candidates_plain``, ``select_candidates_tiles_plain``,
``select_candidates_chained_plain``) for tensors on the CPU and its CUDA
kernel (``myers_cuda.select_words_chained``, ``select_words``,
``select_positions``, ``select_positions_tiles``;
``csrc/select_words.cu``, ``csrc/select_positions.cu``) for tensors on a
CUDA device, with no other fallback. The kernels give the plain versions'
candidates in the same order; callers sort them. The plain position-level
versions expand every position, so they work in bounded chunks (the
batched engine's callers cut a dispatch chunk into sub-ranges for them);
the kernels chain the state across tiles in their own scan, so they take
a whole chunk. Each plain version counts its calls in ``.calls``.

Overshoot costs are ``floor(float32(alpha) * float32(overshoot))`` in
float32 tensors, the reference's f32 rounding (``semantics.py``).

The TPU version compacts screened words in 1024-word blocks into
fixed-size ``cap`` buffers and retries with larger buffers on overflow,
because scatters are slow there. Here the plain version's
``torch.nonzero`` compacts exactly, as the kernels' counting pass does,
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
    "chain_range",
    "last_delta_codes",
    "select_words_chained",
    "select_words_chained_plain",
    "select_words_tiles_q",
    "select_words_tiles_q_plain",
    "select_words_tiles",
    "select_candidates",
    "select_candidates_plain",
    "last_owned_code",
    "select_candidates_tiles",
    "select_candidates_tiles_plain",
    "select_candidates_chained",
    "select_candidates_chained_plain",
    "cummax_1d",
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
    with the scan kernels: ``meta`` ([Q,] NW, T) int32, bit 0 = the word is
    owned and its exact min cost is <= k, bits 1-2 = the decreasing-state
    code at word start from owned deltas earlier in the tile (0 none, 2
    last -1, 3 last +1); ``final`` ([Q,] T) int32, the code after the last
    word. The tile vectors (T,) are shared by the patterns."""
    NW, T = vp_w.shape[-2:]
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
    cm = torch.cummax(enc, dim=-2).values
    prior = torch.cat([torch.zeros_like(cm[..., :1, :]), cm[..., :-1, :]],
                      dim=-2)
    meta = screen.to(torch.int64) | ((prior & 3) << 1)
    return meta.to(torch.int32), (cm[..., -1, :] & 3).to(torch.int32)


def tile_state_chain_codes(tl, is_start, seed_code=None,
                           with_out: bool = False):
    """Cross-tile decreasing-state seeds from per-tile last-owned-delta
    codes (``tl`` (T,): 0 none, 2|sign otherwise, the kernel's ``final``),
    combined by an exclusive cummax in tile order and reset at tiles that
    own a text start (``is_start`` (T,) bool). Returns (T,) int32 in
    {0, 1}: 1 = the last delta before this tile's owned range was +1.
    ``tl`` may have leading axes (one chain per pattern: (Q, T)).

    ``seed_code`` (``tl``'s leading shape, int): the state entering before
    tile 0, coded ``2 + sign`` (0 none), as the sharded search carries it
    across shards; any owned delta or text start beats it. ``with_out``
    also returns the code leaving the last tile, ``max`` of the tile codes
    ``2 * (t + 2) + sign`` (0 when no tile has an owned delta)."""
    T = tl.shape[-1]
    t_ids = torch.arange(T, dtype=torch.int64, device=tl.device)
    tl = tl.to(torch.int64)
    tcode = torch.where(tl > 0, 2 * (t_ids + 2) + (tl & 1), 0)
    cm = _cummax_rows(tcode)
    ld = torch.cat([torch.zeros_like(cm[..., :1]), cm[..., :-1]], dim=-1)
    if seed_code is not None:
        # the incoming state sits at pseudo tile -1: (ld >> 1) == 1
        seed = torch.as_tensor(seed_code, dtype=torch.int64, device=tl.device)
        ld = torch.maximum(ld, seed[..., None])
    scode = torch.where(is_start, t_ids + 2, 0)
    ls = _cummax_rows(scode)
    state0 = torch.where((ld > 0) & ((ld >> 1) >= ls), ld & 1, 0)
    state0 = state0.to(torch.int32)
    if with_out:
        return state0, tcode.amax(dim=-1) if T else tcode.sum(dim=-1)
    return state0


def _cummax_rows(x: torch.Tensor) -> torch.Tensor:
    """``torch.cummax(x, dim=-1).values``; one row (a chain at Q = 1) in
    ``cummax_1d``'s two levels, since ``torch.cummax`` scans a row in one
    thread block on a CUDA device."""
    if x.numel() == x.shape[-1] and x.numel() > 0:
        return cummax_1d(x.reshape(-1)).view(x.shape)
    return torch.cummax(x, dim=-1).values


def overshoot_floor(alpha32: torch.Tensor, over: torch.Tensor) -> torch.Tensor:
    """``floor(alpha * max(over, 0))`` in float32, as int64: the
    reference's overshoot cost (search.rs:1274-1282). A float64 product
    gives other costs (at alpha 0.7 and overshoot 10: 6, where float32
    gives 7)."""
    return torch.floor(
        alpha32 * over.clamp(min=0).to(torch.float32)).to(torch.int64)


def _alpha32(alpha, device) -> torch.Tensor:
    return torch.tensor(alpha, dtype=torch.float32, device=device)


def _bits_delta(vp: torch.Tensor, vm: torch.Tensor) -> torch.Tensor:
    """(N,) int64 words in [0, 2^32) -> (N, 32) per-bit deltas."""
    bit = torch.arange(WB, dtype=torch.int64, device=vp.device)
    return ((vp[:, None] >> bit) & 1) - ((vm[:, None] >> bit) & 1)


def _state_enc(delta, lpos):
    """Nonzero deltas encoded for a cummax: 2p + 1 up, 2p down, 0 none."""
    return torch.where(delta > 0, 2 * lpos + 1,
                       torch.where(delta < 0, 2 * lpos, 0))


def select_words_chained(vp_w, vm_w, cost_w, meta, final, is_start, carry,
                         valid_from, valid_to, islast_at, pos_base, k,
                         all_minima: bool, text_end=None, alpha=None,
                         n_prev: int = 0):
    """Word-level candidate selection of Q patterns with the state chained
    across the tiles: the inputs and outputs of
    ``select_words_chained_plain``, which runs for tensors on the CPU; for
    CUDA tensors the kernel ``myers_cuda.select_words_chained`` runs, chain
    included, and raises on inputs it does not take."""
    if vp_w.device.type == "cpu":
        return select_words_chained_plain(
            vp_w, vm_w, cost_w, meta, final, is_start, carry, valid_from,
            valid_to, islast_at, pos_base, k, all_minima, text_end, alpha,
            n_prev)
    from . import myers_cuda

    return myers_cuda.select_words_chained(
        vp_w, vm_w, cost_w, meta, final, is_start, carry, valid_from,
        valid_to, islast_at, pos_base, k, all_minima, text_end, alpha,
        n_prev)


def select_words_chained_plain(vp_w, vm_w, cost_w, meta, final, is_start,
                               carry, valid_from, valid_to, islast_at,
                               pos_base, k, all_minima: bool, text_end=None,
                               alpha=None, n_prev: int = 0):
    """``select_words_tiles_q_plain`` over tiles whose entering states are
    chained, plain version. Tile t's state is the last owned delta of the
    tiles before it (``final`` (Q, T) int32, the meta scans' codes), reset
    to none at the tiles of ``is_start`` (T,) bool, after ``carry`` (Q, 1)
    int32, the code entering tile 0 (0 none, 2 down, 3 up; None: 0):
    ``chain_range``. Returns the (4, N) columns of
    ``select_words_tiles_q_plain`` and the (Q, 1) int32 code carried out
    (3 up, else 0; with ``all_minima``, where no state is kept, the carry
    in)."""
    select_words_chained_plain.calls += 1
    if carry is None:
        carry = torch.zeros((final.shape[0], 1), dtype=torch.int32,
                            device=final.device)
    if all_minima:
        state0 = torch.zeros_like(final)
    else:
        state0, carry = chain_range(final, is_start, carry)
    return select_words_tiles_q_plain(
        vp_w, vm_w, cost_w, meta, valid_from, valid_to, islast_at, pos_base,
        k, state0, all_minima, text_end, alpha, n_prev), carry


select_words_chained_plain.calls = 0


def select_words_tiles_q(vp_w, vm_w, cost_w, meta, valid_from, valid_to,
                         islast_at, pos_base, k, state0, all_minima: bool,
                         text_end=None, alpha=None, n_prev: int = 0):
    """Word-level candidate selection of Q patterns: the inputs and output
    of ``select_words_tiles_q_plain``, which runs for tensors on the CPU;
    for CUDA tensors the kernel ``myers_cuda.select_words`` runs, and
    raises on inputs it does not take."""
    if vp_w.device.type == "cpu":
        return select_words_tiles_q_plain(
            vp_w, vm_w, cost_w, meta, valid_from, valid_to, islast_at,
            pos_base, k, state0, all_minima, text_end, alpha, n_prev)
    from . import myers_cuda

    return myers_cuda.select_words(
        vp_w, vm_w, cost_w, meta, valid_from, valid_to, islast_at, pos_base,
        k, state0, all_minima, text_end, alpha, n_prev)


def select_words_tiles_q_plain(vp_w, vm_w, cost_w, meta, valid_from,
                               valid_to, islast_at, pos_base, k, state0,
                               all_minima: bool, text_end=None, alpha=None,
                               n_prev: int = 0):
    """Word-level candidate selection of Q patterns, plain version.

    vp_w/vm_w/cost_w/meta: (Q, NW, T) int32 scan outputs; valid_from/
    valid_to: (T,) window-local owned range (valid_from -1 = the tile owns
    position 0); islast_at: (T,) window-local last text position (-1 =
    none); pos_base: (T,) int64 position of window position 0; state0:
    (Q, T) cross-tile state seeds. The tile vectors are shared by the
    patterns.

    With overhang, ``text_end`` (T,) is each tile's window-local text end:
    costs past it add ``floor(alpha * overshoot)``, and the decreasing
    state is recomputed over the ``n_prev`` words before each screened
    word from overshoot-adjusted deltas (the meta codes hold raw deltas
    only): its seed is the meta code at the strip's start, which lies
    before the overshoot or at the tile's word 0.

    ``torch.nonzero`` over the (Q, NW, T) screen finds the screened words;
    only those are expanded to their 33 positions (the word start stands
    for the tile's boundary candidate). Returns a (4, N) int64 tensor on
    the device, [pattern; tile; end position; cost], in (pattern, word,
    tile, position) order.
    """
    select_words_tiles_q_plain.calls += 1
    Q, NW, T = vp_w.shape
    F = Q * NW * T
    dev = vp_w.device
    fidx = torch.nonzero((meta.reshape(-1) & 1) != 0).reshape(-1)
    g_q = fidx // (NW * T)
    g_w = (fidx // T) % NW
    g_tile = fidx % T
    g_vp = u32(vp_w.reshape(-1)[fidx])
    g_vm = u32(vm_w.reshape(-1)[fidx])
    g_cost = cost_w.reshape(-1)[fidx].to(torch.int64)
    g_vfrom = valid_from[g_tile].to(torch.int64)
    g_vto = valid_to[g_tile].to(torch.int64)

    if text_end is not None:
        g_tend = text_end[g_tile].to(torch.int64)[:, None]
        a32 = _alpha32(alpha, dev)
        ovf = lambda p: overshoot_floor(a32, p - g_tend)  # noqa: E731
    else:
        ovf = None

    def adjusted(d32, lp):
        """Per-position total deltas, overshoot steps included."""
        return d32 if ovf is None else d32 + ovf(lp) - ovf(lp - 1)

    lpos = g_w[:, None] * WB + torch.arange(WB + 1, device=dev)[None, :]
    delta32 = adjusted(_bits_delta(g_vp, g_vm), lpos[:, 1:])
    delta = torch.cat([torch.zeros_like(delta32[:, :1]), delta32], dim=1)
    c = g_cost[:, None] + torch.cumsum(delta, dim=1)
    if ovf is not None:
        c = c + ovf(lpos[:, :1])  # the overshoot cost at the word start
    valid = (lpos > g_vfrom[:, None]) & (lpos <= g_vto[:, None])
    # column 0 only stands for the tile boundary position
    valid[:, 0] = (g_w == 0) & (g_vfrom < 0)

    if all_minima:
        mask = valid & (c <= k)
    else:
        # decreasing-state at the (strip's) start word: its own code if an
        # owned delta came earlier in the tile, else the cross-tile seed
        f0 = fidx - torch.clamp(g_w, max=n_prev) * T if n_prev else fidx
        code = (meta.reshape(-1)[f0].to(torch.int64) >> 1) & 3
        g_s0 = state0.reshape(-1)[g_q * T + g_tile]
        g_din = torch.where(code > 0, (code & 1) == 0, g_s0 == 0)
        # first delta of the NEXT word (an artificial +1 past the window)
        f2 = torch.clamp(fidx + T, max=F - 1)
        nf = (u32(vp_w.reshape(-1)[f2]) & 1) - (u32(vm_w.reshape(-1)[f2]) & 1)
        if ovf is not None:
            nref = (g_w[:, None] + 1) * WB + 1
            nf = nf + (ovf(nref) - ovf(nref - 1))[:, 0]
        g_next = torch.where(g_w + 1 < NW, nf, 1)

        # halo positions inside a straddling word are restart artifacts:
        # they must not feed the decreasing-state
        enc = torch.where(lpos > g_vfrom[:, None], _state_enc(delta, lpos), 0)
        cols = [torch.where(g_din, 0, 1)[:, None]]
        for jp in range(n_prev, 0, -1):
            # word g_w - jp, zero before the tile's first word
            has_w = g_w >= jp
            fj = torch.clamp(fidx - jp * T, min=0)
            vpj = torch.where(has_w, u32(vp_w.reshape(-1)[fj]), 0)
            vmj = torch.where(has_w, u32(vm_w.reshape(-1)[fj]), 0)
            lpj = (g_w - jp)[:, None] * WB + torch.arange(
                1, WB + 1, device=dev)[None, :]
            dj = adjusted(_bits_delta(vpj, vmj), lpj)
            cols.append(torch.where((lpj > g_vfrom[:, None]) & has_w[:, None],
                                    _state_enc(dj, lpj), 0))
        cols.append(enc)
        st = torch.cummax(torch.cat(cols, dim=1), dim=1).values
        st = st[:, st.shape[1] - (WB + 1):]
        d = (st == 0) | ((st & 1) == 0)
        delta_next = torch.cat([delta[:, 1:], g_next[:, None]], dim=1)
        g_ilast = islast_at[g_tile].to(torch.int64)
        next_gt = (delta_next >= 1) | (lpos == g_ilast[:, None])
        mask = valid & (c <= k) & next_gt & d

    pos = pos_base[g_tile][:, None] + lpos
    row = torch.nonzero(mask)[:, 0]
    return torch.stack([g_q[row], g_tile[row], pos[mask], c[mask]])


select_words_tiles_q_plain.calls = 0


def select_words_tiles(vp_w, vm_w, cost_w, meta, valid_from, valid_to,
                       islast_at, pos_base, k, state0, all_minima: bool,
                       text_end=None, alpha=None, n_prev: int = 0):
    """``select_words_tiles_q`` of one pattern: (NW, T) scan outputs and
    (T,) state seeds. Returns a (2, N) int64 tensor on the device, [end
    positions; costs], in (word, tile, position) order."""
    return select_words_tiles_q(
        vp_w[None], vm_w[None], cost_w[None], meta[None], valid_from,
        valid_to, islast_at, pos_base, k, state0[None], all_minima,
        text_end, alpha, n_prev,
    )[2:]


def last_delta_codes(vp_w, vm_w, valid_from, valid_to) -> torch.Tensor:
    """([Q,] T) int32 code of each tile's last owned delta: 0 none, 2 | 1
    for +1, 2 for -1 (the meta kernels' ``final``, from raw deltas)."""
    NW = vp_w.shape[-2]
    widx = torch.arange(NW, dtype=torch.int64, device=vp_w.device).view(NW, 1)
    omask = _owned_delta_masks(widx, valid_from.to(torch.int64),
                               valid_to.to(torch.int64))
    vp_o = u32(vp_w) & omask
    vm_o = u32(vm_w) & omask
    s_w = _last_delta_up(vp_o, vm_o).to(torch.int64)
    enc = torch.where((vp_o | vm_o) != 0, ((widx + 1) << 2) | (2 | s_w), 0)
    return (enc.amax(dim=-2) & 3).to(torch.int32)


#: Positions one chunk of the position-level selections expands: each
#: takes up to ~100 bytes of temporaries (deltas, costs, overshoot costs,
#: state encodings and the cummax's values and indices, int64 in the
#: single engine's flat positions), so a chunk peaks at ~3.4 GB.
POSITIONS_PER_CHUNK = 1 << 25


def cummax_1d(x: torch.Tensor, width: int = 1024) -> torch.Tensor:
    """Inclusive running maximum of a 1-D tensor, as ``torch.cummax(x,
    0).values``, in two levels: within rows of ``width`` elements, then
    each row's carry from the rows before it. On a CUDA device
    ``torch.cummax`` scans one row in one thread block, so over one long
    row it runs nearly serially; rows run in parallel."""
    n = x.numel()
    rows = -(-n // width)
    low = torch.iinfo(x.dtype).min
    if rows * width > n:
        x = torch.cat([x, x.new_full((rows * width - n,), low)])
    m = torch.cummax(x.view(rows, width), dim=1).values
    if rows > 1:
        carry = torch.cummax(m[:, -1], dim=0).values
        m = torch.maximum(m, torch.cat([carry.new_full((1,), low),
                                        carry[:-1]])[:, None])
    return m.reshape(-1)[:n]


def _word_bits(vp, vm, cost):
    """(N,) int32 words and word-start costs -> (N, 32) int32 deltas and
    per-position costs (``(x >> b) & 1`` of an int32 is bit b)."""
    bit = torch.arange(WB, dtype=torch.int32, device=vp.device)
    delta = ((vp[:, None] >> bit) & 1) - ((vm[:, None] >> bit) & 1)
    return delta, cost[:, None] + torch.cumsum(delta, dim=1, dtype=torch.int32)


def _flat_words(x: torch.Tensor, W: int, halo: int, f0: int,
                f1: int) -> torch.Tensor:
    """Flat owned words f0..f1 - 1 of (NW, T) tiled scan outputs: flat word
    f is word ``f % W`` of tile ``f // W``'s owned range (window words
    [halo, halo + W) of tile t >= 1, [0, W) of tile 0)."""
    f = torch.arange(f0, f1, dtype=torch.int64, device=x.device)
    t = f // W
    return x[f % W + torch.where(t > 0, halo, 0), t]


def last_owned_code(vp_w, vm_w, W: int, halo: int, lo: int, hi: int,
                    n_text: int, alpha) -> int:
    """The code of the last nonzero cost delta at the flat positions
    lo..hi of ``select_candidates``' tiled scan outputs: 0 none, 2 for
    -1, 3 for +1. Deltas past ``n_text`` include the overshoot cost's
    steps, as the selection sees them. The sharded search passes it to
    the shards after this one; ``hi - n_text`` is at most the overhang
    steps there, so only those positions are expanded."""
    lo = max(lo, 1)
    if hi < lo:
        return 0
    dev = vp_w.device
    raw_hi = hi if alpha is None else min(hi, n_text)
    if alpha is not None and hi > max(lo - 1, n_text):
        p = torch.arange(max(lo - 1, n_text) + 1, hi + 1, dtype=torch.int64,
                         device=dev)
        f0 = int(p[0] - 1) // WB
        f1 = int(p[-1] - 1) // WB + 1
        vp = u32(_flat_words(vp_w, W, halo, f0, f1))
        vm = u32(_flat_words(vm_w, W, halo, f0, f1))
        b = (p - 1) % WB
        i = (p - 1) // WB - f0
        a32 = _alpha32(alpha, dev)
        delta = (((vp[i] >> b) & 1) - ((vm[i] >> b) & 1)
                 + overshoot_floor(a32, p - n_text)
                 - overshoot_floor(a32, p - 1 - n_text))
        nz = torch.nonzero(delta).view(-1)
        if nz.numel():
            return 2 + int(delta[nz[-1]] > 0)
    if raw_hi < lo:
        return 0
    f0, f1 = (lo - 1) // WB, (raw_hi - 1) // WB + 1
    widx = torch.arange(f0, f1, dtype=torch.int64, device=dev)
    omask = _owned_delta_masks(widx, torch.tensor(lo - 1, device=dev),
                               torch.tensor(raw_hi, device=dev))
    vp_o = u32(_flat_words(vp_w, W, halo, f0, f1)) & omask
    vm_o = u32(_flat_words(vm_w, W, halo, f0, f1)) & omask
    nz = torch.nonzero((vp_o | vm_o) != 0).view(-1)
    if nz.numel() == 0:
        return 0
    last = nz[-1]
    return 2 + int(_last_delta_up(vp_o[last], vm_o[last]))


def select_candidates(vp_w, vm_w, cost_w, W: int, halo: int, boundary_m: int,
                      n_text: int, max_pos: int, k: int, alpha,
                      all_minima: bool, min_pos: int | None = None,
                      owned_end: int | None = None, state0: int | None = None):
    """Position-level candidate selection of one text: the inputs and
    output of ``select_candidates_plain``, which runs for tensors on the
    CPU; for CUDA tensors the kernel ``myers_cuda.select_positions`` runs,
    and raises on inputs it does not take."""
    if vp_w.device.type == "cpu":
        return select_candidates_plain(
            vp_w, vm_w, cost_w, W, halo, boundary_m, n_text, max_pos, k,
            alpha, all_minima, min_pos, owned_end, state0)
    from . import myers_cuda

    return myers_cuda.select_positions(
        vp_w, vm_w, cost_w, W, halo, boundary_m, n_text, max_pos, k, alpha,
        all_minima, min_pos, owned_end, state0)


def select_candidates_plain(vp_w, vm_w, cost_w, W: int, halo: int,
                            boundary_m: int, n_text: int, max_pos: int,
                            k: int, alpha, all_minima: bool,
                            min_pos: int | None = None,
                            owned_end: int | None = None,
                            state0: int | None = None):
    """Position-level candidate selection of one text (the single engine's
    overhang path with a long overshoot span), plain version.

    vp_w/vm_w/cost_w: (NW, T) int32 scan outputs of the halo-tiled windows
    (NW = W + halo + 1). The owned words (window words [halo, halo + W) of
    tile t >= 1, [0, W) of tile 0) are the flat positions 1..T*W*32 of the
    text; position 0 costs ``boundary_m``. Costs past ``n_text`` add the
    overshoot cost; positions past ``max_pos`` are never reported. The
    decreasing state is one cummax over all positions (the reference's
    ``minima.select_candidates``), run in chunks of whole tiles with the
    last state carried across chunk edges. Returns a (2, N) int64 tensor,
    [end positions; costs], in position order.

    The sharded search passes its owner-computes range: only positions in
    [``min_pos``, ``owned_end``] are reported, and with ``state0`` (1 = the
    last delta before ``min_pos`` was +1, from the shards before this
    one) the deltas below ``min_pos``, restart artifacts of the halo, do
    not feed the decreasing state (reference ``minima.py:43-107``).
    """
    select_candidates_plain.calls += 1
    NW, T = vp_w.shape
    dev = vp_w.device
    t_chunk = max(1, POSITIONS_PER_CHUNK // (W * WB))
    a32 = _alpha32(alpha if alpha is not None else 0.0, dev)
    ov = lambda p: overshoot_floor(a32, p - n_text)  # noqa: E731

    def owned(x, t0, t1):
        o = x[halo : halo + W, t0:t1]
        if t0 == 0:
            o = o.clone()
            o[:, 0] = x[:W, 0]
        return o.T.reshape(-1)  # flat word order: tile-major

    def first_delta(t):
        """The adjusted delta at tile t's first owned position."""
        if t >= T:
            return 1
        p = torch.tensor([t * W * WB + 1], dtype=torch.int64, device=dev)
        d = (int(vp_w[halo, t]) & 1) - (int(vm_w[halo, t]) & 1)
        return d + int(ov(p) - ov(p - 1))

    found = []
    # the encoded last nonzero delta before the chunk (position 0 codes +1
    # as 1, as the reference seeds it)
    carry = -1 if not state0 else 1
    lo = 0 if min_pos is None else min_pos
    for t0 in range(0, T, t_chunk):
        t1 = min(T, t0 + t_chunk)
        d32, c32 = _word_bits(owned(vp_w, t0, t1), owned(vm_w, t0, t1),
                              owned(cost_w, t0, t1))
        p = t0 * W * WB + 1 + torch.arange(d32.numel(), dtype=torch.int64,
                                           device=dev)
        delta = d32.reshape(-1).to(torch.int64)
        c = c32.reshape(-1).to(torch.int64)
        if t0 == 0:  # position 0, the boundary
            p = torch.cat([p.new_zeros(1), p])
            delta = torch.cat([delta.new_zeros(1), delta])
            c = torch.cat([c.new_full((1,), boundary_m), c])
        ovp = ov(p)
        c = c + ovp
        delta = delta + ovp - ov(p - 1)
        mask = (p <= max_pos) & (c <= k) & (p >= lo)
        if owned_end is not None:
            mask &= p <= owned_end
        if not all_minima:
            enc = torch.where(delta > 0, 2 * p + 1,
                              torch.where(delta < 0, 2 * p, -1))
            if state0 is not None:
                enc = torch.where(p >= lo, enc, -1)
            enc[0] = max(int(enc[0]), carry)
            m2 = cummax_1d(enc)
            carry = int(m2[-1])
            d = (m2 < 0) | ((m2 & 1) == 0)
            nxt = torch.cat([delta[1:], delta.new_full((1,), first_delta(t1))])
            mask &= d & ((nxt >= 1) | (p == max_pos))
        found.append(torch.stack([p[mask], c[mask]]))
    return torch.cat(found, dim=1)


select_candidates_plain.calls = 0


def select_candidates_tiles(vp_w, vm_w, cost_w, boundary0, text_end,
                            valid_from, valid_to, islast_at, pos_base, k,
                            alpha, state0, all_minima: bool):
    """Position-level candidate selection of Q patterns over pieces: the
    inputs and output of ``select_candidates_tiles_plain``, which runs for
    tensors on the CPU; for CUDA tensors the kernel
    ``myers_cuda.select_positions_tiles`` runs (every piece entering with
    its ``state0``), and raises on inputs it does not take."""
    if vp_w.device.type == "cpu":
        return select_candidates_tiles_plain(
            vp_w, vm_w, cost_w, boundary0, text_end, valid_from, valid_to,
            islast_at, pos_base, k, alpha, state0, all_minima)
    from . import myers_cuda

    return myers_cuda.select_positions_tiles(
        vp_w, vm_w, cost_w, boundary0, text_end, valid_from, valid_to,
        islast_at, pos_base, k, alpha, state0, all_minima)[0]


def chain_range(final, is_start, carry):
    """The state entering each of a range of pieces ((Q, T) int32, 1 up)
    and the (Q, 1) int32 code carried out of it (3 up, else 0), from each
    piece's last-delta code ``final`` (Q, T), the pieces that start a
    text ``is_start`` (T,) and the code carried in ``carry`` (Q, 1): the
    carry enters as a virtual piece before the first, and a virtual piece
    after the last reads the state carried on."""
    edge = torch.zeros(1, dtype=torch.bool, device=final.device)
    st = tile_state_chain_codes(
        torch.cat([carry, final, torch.zeros_like(carry)], 1),
        torch.cat([edge, is_start, edge]))
    return st[:, 1:-1], torch.where(st[:, -1:] == 1, 3, 0).to(torch.int32)


def select_candidates_chained(vp_w, vm_w, cost_w, boundary0, text_end,
                              valid_from, valid_to, islast_at, pos_base, k,
                              alpha, is_start, carry, all_minima: bool):
    """``select_candidates_tiles`` with the state chained across the
    pieces, as the batched engine selects a range of pieces: the inputs
    and outputs of ``select_candidates_chained_plain``, which runs for
    tensors on the CPU; for CUDA tensors the kernel
    ``myers_cuda.select_positions_tiles`` runs, chain included, and raises
    on inputs it does not take."""
    if vp_w.device.type == "cpu":
        return select_candidates_chained_plain(
            vp_w, vm_w, cost_w, boundary0, text_end, valid_from, valid_to,
            islast_at, pos_base, k, alpha, is_start, carry, all_minima)
    from . import myers_cuda

    return myers_cuda.select_positions_tiles(
        vp_w, vm_w, cost_w, boundary0, text_end, valid_from, valid_to,
        islast_at, pos_base, k, alpha, None, all_minima, is_start=is_start,
        carry=carry)


def select_candidates_chained_plain(vp_w, vm_w, cost_w, boundary0, text_end,
                                    valid_from, valid_to, islast_at,
                                    pos_base, k, alpha, is_start, carry,
                                    all_minima: bool):
    """``select_candidates_tiles_plain`` over pieces whose entering states
    are chained, plain version. Piece t's state is the last raw delta
    code of the pieces before it (``last_delta_codes`` over (valid_from,
    valid_to]), reset to none at the pieces of ``is_start`` (T,) bool,
    after ``carry`` (Q, 1) int32, the code entering piece 0 (0 none, 3
    up): ``chain_range``. Returns the (4, N) columns of
    ``select_candidates_tiles_plain`` and the (Q, 1) int32 code carried
    out (3 up, else 0; with ``all_minima``, where no state is kept,
    ``carry``)."""
    select_candidates_chained_plain.calls += 1
    if all_minima:
        state0 = torch.zeros(vp_w.shape[0], vp_w.shape[-1],
                             dtype=torch.int32, device=vp_w.device)
    else:
        state0, carry = chain_range(
            last_delta_codes(vp_w, vm_w, valid_from, valid_to), is_start,
            carry)
    return select_candidates_tiles_plain(
        vp_w, vm_w, cost_w, boundary0, text_end, valid_from, valid_to,
        islast_at, pos_base, k, alpha, state0, all_minima), carry


select_candidates_chained_plain.calls = 0


def select_candidates_tiles_plain(vp_w, vm_w, cost_w, boundary0, text_end,
                                  valid_from, valid_to, islast_at, pos_base,
                                  k, alpha, state0, all_minima: bool):
    """Position-level candidate selection of Q patterns over pieces (the
    batched engine's overhang path with a long overshoot span), plain
    version.

    vp_w/vm_w/cost_w: (Q, NW, T) int32 scan outputs; boundary0: (Q, T) cost
    at each piece's position 0; text_end, valid_from, valid_to, islast_at:
    (T,) piece-local; pos_base: (T,) int64; state0: (Q, T) cross-piece
    state seeds. Every piece position 0..NW*32 is expanded, so callers
    bound Q * T * NW * 32 (``POSITIONS_PER_CHUNK``). Returns a (4, N) int64
    tensor, [pattern; tile; end position; cost], in (pattern, tile,
    position) order.
    """
    select_candidates_tiles_plain.calls += 1
    Q, NW, T = vp_w.shape
    N = NW * WB
    dev = vp_w.device
    d32, c32 = _word_bits(vp_w.reshape(-1), vm_w.reshape(-1),
                          cost_w.reshape(-1))
    # (Q, NW, T, 32) -> (Q, T, NW * 32): piece positions in order
    flat = lambda x: x.view(Q, NW, T, WB).permute(0, 2, 1, 3).reshape(Q, T, N)  # noqa: E731
    delta = torch.cat([d32.new_zeros(Q, T, 1), flat(d32)], dim=2)
    c = torch.cat([boundary0.to(torch.int32)[..., None], flat(c32)], dim=2)
    pos = torch.arange(N + 1, dtype=torch.int32, device=dev)[None, :]
    a32 = _alpha32(alpha, dev)
    tend = text_end.to(torch.int64)[:, None]
    ov = overshoot_floor(a32, pos - tend).to(torch.int32)  # (T, N + 1)
    ov_prev = overshoot_floor(a32, pos - 1 - tend).to(torch.int32)
    c = c + ov
    delta = delta + (ov - ov_prev)
    vf = valid_from[:, None]
    mask = (pos > vf) & (pos <= valid_to[:, None]) & (c <= k)
    if not all_minima:
        # halo deltas are restart artifacts: the cross-piece chain seeds
        # column 0 instead
        enc = torch.where(delta > 0, 2 * pos + 1,
                          torch.where(delta < 0, 2 * pos, -1))
        enc = torch.where(pos > vf, enc, -1)
        enc[..., 0] = torch.where(state0 > 0, 1, -1)
        m2 = torch.cummax(enc, dim=2).values
        d = (m2 < 0) | ((m2 & 1) == 0)
        nxt = torch.cat([delta[..., 1:], delta.new_ones(Q, T, 1)], dim=2)
        mask &= d & ((nxt >= 1) | (pos == islast_at[:, None]))
    q, t, p = torch.nonzero(mask).T
    return torch.stack([q, t, pos_base[t] + p, c[mask].to(torch.int64)])


select_candidates_tiles_plain.calls = 0
