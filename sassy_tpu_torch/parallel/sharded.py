"""Sharded search over a ('pat', 'text') grid of shard slots.

Port of ``sassy_tpu/parallel/sharded.py``. The reference runs one SPMD
program over a ``jax.sharding.Mesh``; here a ``Mesh`` is a grid of
``n_pat x n_text`` shard slots, and each rank of a ``torch.distributed``
process group (or the one process, without a group) works through its own
contiguous run of slots on its one device, slot after slot:

- **text axis**: the packed text planes are cut into ``Dt`` shards of
  ``S`` words. Shard d owns the end positions ``(d*S*32, (d+1)*S*32]``
  (shard 0 also owns position 0). Its window is ``[left H | owned S |
  right 1]`` words, ``[owned S | right H + 1]`` for shard 0, which alone
  starts from the text's true start boundary (the overhang h deltas);
  ``H`` words of left context hold every alignment of an owned end, and
  one right word gives the minima rule its lookahead delta. The halo
  words of a shard held by another rank come over one
  ``torch.distributed.all_gather`` of every slot's first ``H + 1`` and
  last ``H`` words (the reference's ``lax.ppermute``).
- **the scan**: each slot's window is tiled with the port's H100 plan
  (``plan.plan_tiles``, ``tile_windows``: each tile's first word and the
  end of its words in the slot's planes, which the kernels read in place)
  and scanned by the hand-written kernels: without overhang q1meta (one
  pattern a slot) or q2meta, with
  the ACGT-pure eq when every pattern is pure, after the suffix prefilter
  where it pays (``plan.HIER_MIN_SAVED_PAIRS``); with overhang q1 or q2
  and the position-level selection, as the reference selects every
  overshoot at position level (it runs an XLA scan there; the port has
  none).
- **the decreasing state** crosses shards as in the reference: every slot
  all-gathers the code of its last owned delta, ``2 * (shard + 2) +
  sign``, and a shard's seed is the largest code of the shards before it
  (the chain resets only at shard 0), so plateaus spanning any number of
  shards select exactly as on one device.
- **pattern axis**: equal-length patterns are padded to a multiple of
  ``Dp`` with repeats of pattern 0 and split into ``Dp`` groups; the text
  is replicated along the axis.
- every rank gathers every slot's ``(pos, cost)`` candidates and returns
  the full per-pattern sorted lists, with the owner-computes statistics
  in ``last_stats``.

Positions and plane offsets are int64 throughout. The candidate lists
equal the port's single-device engines'.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import semantics
from ..ops import minima, myers_cuda, plan
from ..ops.bitpack import WORD_BITS
from ..ops.myers_torch import (
    Windows,
    _upload,
    aligned_words,
    engine_device,
    overlay_n_tail,
    pack,
    state_from_numpy,
    tile_windows,
)
from ..ops.plan import (
    _bucket_rows,
    _masks_pure_np,
    cdiv,
    halo_words,
    next_pow2,
    pattern_inputs_np,
    plan_tiles,
)
from ..profiles import Profile, as_bytes_array

__all__ = ["Mesh", "ShardedSearch", "ShardedText", "make_mesh"]

WB = WORD_BITS

#: The steps ``ShardedSearch.last_times`` reports, in order.
STEPS = ("pack", "halo", "scan", "chain", "select", "gather")


@dataclass(frozen=True)
class Mesh:
    """A ('pat', 'text') grid of ``n_pat x n_text`` shard slots, row-major
    as the reference's ``make_mesh`` lays out devices: slot ``p * n_text +
    d`` scans text shard d for pattern group p. Rank r of the default
    process group holds the slots ``[r * per, (r + 1) * per)``, ``per =
    slots / world``, all on its one ``device``; without a process group
    (``distributed`` False) one process holds them all."""

    n_pat: int
    n_text: int
    device: torch.device
    rank: int = 0
    world: int = 1
    distributed: bool = False

    @property
    def shape(self) -> dict:
        return {"pat": self.n_pat, "text": self.n_text}

    @property
    def size(self) -> int:
        return self.n_pat * self.n_text

    @property
    def slots(self) -> range:
        """The global slot ids this rank holds."""
        per = self.size // self.world
        return range(self.rank * per, (self.rank + 1) * per)


def make_mesh(n_text: int | None = None, n_pat: int = 1,
              device="cuda") -> Mesh:
    """A ('pat', 'text') mesh of ``n_pat x n_text`` slots over the ranks of
    the default process group (when one is initialized, else this process
    alone), each rank's slots on ``device`` ("cuda" is the
    current CUDA device, and raises without one). ``n_text`` defaults to
    one slot per rank; the world size must divide the slot count."""
    distributed = dist.is_available() and dist.is_initialized()
    if distributed:
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    dev = engine_device(device, "make_mesh")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if distributed and dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL process group moves CUDA tensors: the "
                         f"slots cannot lie on {dev}")
    if n_text is None:
        n_text = max(1, world // n_pat)
    if n_pat < 1 or n_text < 1 or (n_pat * n_text) % world:
        raise ValueError(f"a {n_pat} x {n_text} mesh does not split over "
                         f"{world} ranks")
    return Mesh(n_pat, n_text, dev, rank, world, distributed)


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(world, *x.shape): ``x`` of every rank in rank order, on x's device.
    NCCL moves CUDA tensors; gloo moves CPU tensors, so a CUDA tensor is
    staged through the host (which is how ranks that share a card talk).
    Within a process group the collective runs even for one rank."""
    if not mesh.distributed:
        return x[None]
    if dist.get_backend() == "nccl":
        src = x.contiguous()
    else:
        src = x.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src)
    return torch.stack(parts).to(x.device)


class ShardedText:
    """A text for repeated sharded searches: each rank packs only its own
    shards, on its device, memoised per (shard count, shard words,
    overhang steps) and the shards and device asked for (at most 8
    entries). ``text_raw`` is bytes, a uint8 array, or a uint8 tensor (on
    any device: a text made on the card stays there)."""

    def __init__(self, profile: Profile, text_raw):
        self.profile = profile
        if isinstance(text_raw, torch.Tensor):
            self.raw = text_raw.reshape(-1)
        else:
            self.raw = as_bytes_array(text_raw)
        self.n = int(self.raw.shape[0])
        self._memo: dict = {}

    def planes_sharded(self, Dt: int, S: int, steps: int, shards,
                       device) -> dict[int, torch.Tensor]:
        """{d: (P, S) int32 packed planes of text shard d} for ``shards``
        on ``device``; with overhang, the ``steps`` positions past the text
        end hold the profile's overhang pad code (reference
        ``sharded.py:80-82``)."""
        shards = tuple(sorted(set(shards)))
        key = (Dt, S, steps, shards, str(device))
        got = self._memo.get(key)
        if got is None:
            got = {d: self._pack_shard(d, S, steps, device) for d in shards}
            if len(self._memo) >= 8:
                self._memo.clear()
            self._memo[key] = got
        return got

    def _pack_shard(self, d: int, S: int, steps: int, device) -> torch.Tensor:
        prof = self.profile
        c0 = d * S * WB
        n_d = min(max(self.n - c0, 0), S * WB)
        # the shard's n_d bytes as they are: the pack zeroes the words past
        planes = pack(_upload(self.raw[c0 : c0 + n_d], device), n_d // WB,
                      n_d % WB, prof.planes, False, prof.pack_mode,
                      prof.pack_shift, prof.pack_mask,
                      tuple(prof.pack_plane_masks), prof.pack_fold_case, S)
        lo, hi = max(self.n - c0, 0), min(self.n + steps - c0, S * WB)
        if steps and hi > lo and prof.overhang_pad_code:
            # plane p of the pad code's positions = bit p of the pad code
            bit = torch.tensor([(prof.overhang_pad_code >> p) & 1
                                for p in range(prof.planes)],
                               dtype=torch.bool, device=device)
            planes = torch.where(bit[:, None],
                                 overlay_n_tail(planes, lo, hi), planes)
        return planes


@dataclass
class _Slot:
    """One slot's window and tile plan, window-local unless named."""

    s: int  # global slot id
    p: int  # pattern group
    d: int  # text shard
    first: bool
    offset: int  # absolute position of window position 0
    min_pos: int  # first owned window position
    owned_end: int  # last owned window position
    windows: Windows | None = None  # the tiles' windows in the planes
    W: int = 0
    halo: int = 0
    start: torch.Tensor | None = None  # (T,) bool: tile 0 of shard 0
    vf: torch.Tensor | None = None  # (T,) int32
    vt: torch.Tensor | None = None  # (T,) int32
    il: torch.Tensor | None = None  # (T,) int32
    pos_base: torch.Tensor | None = None  # (T,) int64 absolute
    outs: tuple | None = None  # the scan's outputs, with a pattern axis
    codes: list | None = None  # per pattern: 2 * (d + 2) + sign, or 0


class ShardedSearch:
    """Batched (equal-length patterns) x (one long text) search over a
    ``Mesh``; ``mesh`` defaults to ``make_mesh(device=device)``, one slot
    of this process on the card. ``hier`` forces the suffix prefilter on
    (True) or off (False); None runs it where it saves at least
    ``plan.HIER_MIN_SAVED_PAIRS`` (row, word) pairs of a slot's scan.

    Returns the same (end position, cost) candidate lists as the port's
    single-device engines. The dna and iupac profiles only: ascii raises
    ``NotImplementedError``, as in the reference. With ``timed``, each
    search records the seconds of each step of ``STEPS`` in
    ``last_times``: on a card from CUDA events at the steps' ends, read
    once the search is done, so that timing adds no synchronise (a step's
    time is then the device clock's from the end of the step before,
    host work it waits for included); on the CPU from the host clock.
    Without it (the default) ``last_times`` stays empty."""

    def __init__(self, mesh: Mesh | None = None, hier: bool | None = None,
                 device="cuda", timed: bool = False):
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.hier = hier
        self.timed = timed
        self.last_stats: dict | None = None
        self.last_times: dict = {}
        self._events: list = []

    def _tick(self, step: str, t0: float) -> float:
        if not self.timed:
            return t0
        dev = self.mesh.device
        if dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(dev))
            self._events.append((step, ev))
            return t0
        now = time.perf_counter()
        if step in self.last_times:
            self.last_times[step] += now - t0
        return now

    def _read_events(self) -> None:
        """``last_times`` from the CUDA events of a timed search."""
        if not self._events:
            return
        self._events[-1][1].synchronize()
        for (_, a), (step, b) in zip(self._events, self._events[1:]):
            self.last_times[step] = a.elapsed_time(b) / 1e3
        self._events = []

    def candidates_batch(self, profile: Profile, patterns, text_raw, k: int,
                         alpha: float | None = None,
                         max_overhang: int | None = None,
                         all_minima: bool = False) -> list[list[tuple]]:
        """Per-pattern sorted (end position, cost) candidate lists; the
        patterns must have equal lengths."""
        if profile.eq_mode != "iupac":
            raise NotImplementedError(
                "sharded search supports dna/iupac profiles")
        mesh = self.mesh
        dev = mesh.device
        Dt, Dp = mesh.n_text, mesh.n_pat
        pcodes = [profile.encode(p) for p in patterns]
        Q = len(pcodes)
        if Q == 0:
            return []
        m = len(pcodes[0])
        if any(len(c) != m for c in pcodes):
            raise ValueError("sharded batch requires equal-length patterns")
        self.last_times = dict.fromkeys(STEPS, 0.0) if self.timed else {}
        self._events = []
        t0 = self._tick("start", time.perf_counter())

        st = (text_raw if isinstance(text_raw, ShardedText)
              else ShardedText(profile, text_raw))
        n = st.n
        steps = semantics.overhang_steps(m, k, alpha, max_overhang)
        max_pos = n + steps
        M = _bucket_rows(m)
        H = next_pow2(cdiv(M + k, WB))
        words_needed = max(1, cdiv(max_pos, WB))
        S = max(cdiv(words_needed, Dt), H + 1)

        per = [pattern_inputs_np(profile, c, alpha, max_overhang)
               for c in pcodes]
        Qe = cdiv(Q, Dp) * Dp
        Ql = Qe // Dp
        pm = np.stack([x[0] for x in per])
        if Qe > Q:
            pm = np.concatenate([pm, np.repeat(pm[:1], Qe - Q, axis=0)])
        is_pad, h_init, boundary_m = per[0][1], per[0][2], per[0][3]
        eq_mode = ("pure" if all(_masks_pure_np(x[0], x[1]) for x in per)
                   else "iupac")
        pm_t, pad_t, hinit_t = state_from_numpy(pm, is_pad, h_init,
                                                device=dev)
        fast = alpha is None

        slots = []
        for s in mesh.slots:
            p, d = divmod(s, Dt)
            first = d == 0
            slots.append(_Slot(
                s=s, p=p, d=d, first=first,
                offset=0 if first else (d * S - H) * WB,
                min_pos=0 if first else H * WB + 1,
                owned_end=S * WB if first else (H + S) * WB,
            ))
        planes = st.planes_sharded(Dt, S, steps, [sl.d for sl in slots], dev)
        t0 = self._tick("pack", t0)

        # halo exchange: every slot's first H + 1 and last H words
        edges = _all_gather(torch.stack([
            torch.cat([planes[sl.d][:, : H + 1], planes[sl.d][:, S - H :]], 1)
            for sl in slots]), mesh).reshape(Dp * Dt, -1, 2 * H + 1)
        P = edges.shape[1]
        # a slot's window: S + H + 1 words, zero-padded to the kernels' row
        # alignment in the same copy
        words = S + H + 1
        tail = torch.zeros((P, aligned_words(words) - words),
                           dtype=torch.int32, device=dev)
        wins = {}
        for d in sorted(planes):
            right = (edges[d + 1, :, : H + 1] if d + 1 < Dt else
                     torch.zeros((P, H + 1), dtype=torch.int32, device=dev))
            if d == 0:
                wins[d] = torch.cat([planes[d], right, tail], 1)
            else:
                wins[d] = torch.cat([edges[d - 1, :, H + 1 :], planes[d],
                                     right[:, :1], tail], 1)
        t0 = self._tick("halo", t0)

        halo_t = halo_words(M, k)
        m_q = torch.full((Ql,), m, dtype=torch.int32, device=dev)
        bm_q = torch.full((Ql,), boundary_m, dtype=torch.int32, device=dev)
        hier_s = plan.suffix_rows(m, k) if fast else 0
        if not 0 < hier_s < M:
            hier_s = 0
        planned: dict = {}
        for sl in slots:
            q0 = sl.p * Ql
            self._plan_slot(sl, wins[sl.d], words, halo_t, max_pos, planned)
            pmq = pm_t[q0 : q0 + Ql]
            if fast and hier_s and self._hier_on(Ql, M, hier_s, sl):
                self._prefilter(sl, pmq, hier_s, k, eq_mode)
            if sl.windows is None:  # no tile flagged: no candidate, no code
                sl.codes = [0] * Ql
                continue
            sl.outs = self._scan(sl, pmq, pad_t, hinit_t, m, boundary_m,
                                 m_q, bm_q, k, eq_mode, fast)
            if all_minima:
                sl.codes = [0] * Ql
            elif fast:
                _, out = minima.tile_state_chain_codes(sl.outs[4], sl.start,
                                                       with_out=True)
                sl.codes = [int(2 * (sl.d + 2) + (c & 1)) if c > 0 else 0
                            for c in out.tolist()]
            else:
                hi = min(sl.owned_end, max_pos - sl.offset)
                sl.codes = []
                for q in range(Ql):
                    c = minima.last_owned_code(
                        sl.outs[0][q], sl.outs[1][q], sl.W, sl.halo,
                        sl.min_pos, hi, n - sl.offset, alpha)
                    sl.codes.append(2 * (sl.d + 2) + (c & 1) if c else 0)
        t0 = self._tick("scan", t0)

        codes = _all_gather(torch.tensor([sl.codes for sl in slots],
                                         dtype=torch.int64, device=dev),
                            mesh).reshape(Dp, Dt, Ql).cpu()
        t0 = self._tick("chain", t0)

        found = []
        for sl in slots:
            if sl.outs is None:
                continue
            prev = (codes[sl.p, : sl.d].amax(dim=0) if sl.d
                    else torch.zeros(Ql, dtype=torch.int64))
            if fast:
                cols = self._select_words(sl, prev, k, all_minima)
            else:
                cols = self._select_positions(
                    sl, prev, boundary_m if sl.first else m, n, max_pos, k,
                    alpha, all_minima)
            cols[0] += sl.p * Ql
            found.append(torch.cat([torch.full_like(cols[:1], sl.s), cols]))
            sl.outs = None
        local = (torch.cat(found, 1) if found
                 else torch.zeros((4, 0), dtype=torch.int64, device=dev))
        local = local[:, local[1] < Q]
        t0 = self._tick("select", t0)

        got = self._gather(local).numpy()
        self._tick("gather", t0)
        self._read_events()
        return self._results(got, Q, Ql, S, Dt, Dp, max_pos, fast)

    # -- one slot ---------------------------------------------------------
    _PLANNED = ("windows", "W", "halo", "start", "vf", "vt", "il",
                "pos_base")

    def _plan_slot(self, sl: _Slot, win: torch.Tensor, words: int,
                   halo: int, max_pos: int, planned: dict) -> None:
        """Tile the slot's window, the first ``words`` words of its (P, L)
        planes (L a multiple of the kernels' row alignment, zero past
        ``words``), with the H100 plan (the descriptors of
        ``tile_windows``) and intersect each tile's owned range with the
        shard's (reference
        ``sharded.py:247-266``); the slots of one shard share the plan
        (``planned``, by shard)."""
        if sl.d in planned:
            for f, v in zip(self._PLANNED, planned[sl.d]):
                setattr(sl, f, v)
            return
        dev = win.device
        T, W, halo = plan_tiles(words, halo)
        sl.W, sl.halo = W, halo
        sl.windows = tile_windows(win, T, W, halo)
        tile = torch.arange(T, dtype=torch.int64, device=dev)
        ws = torch.where(tile == 0, 0, (tile * W - halo) * WB)
        vf = torch.where(tile == 0, -1, halo * WB)
        vt_raw = torch.where(tile == 0, W * WB, (halo + W) * WB)
        hi_own = min(sl.owned_end, max_pos - sl.offset)
        vf = torch.maximum(vf, sl.min_pos - 1 - ws)
        vt = torch.clamp(torch.minimum(vt_raw, hi_own - ws), min=-1)
        rel_last = (max_pos - sl.offset) - ws
        il = torch.where((rel_last > vf) & (rel_last <= vt_raw), rel_last, -1)
        sl.vf, sl.vt, sl.il = (x.to(torch.int32) for x in (vf, vt, il))
        sl.pos_base = sl.offset + ws
        sl.start = (tile == 0) & sl.first
        planned[sl.d] = tuple(getattr(sl, f) for f in self._PLANNED)

    def _hier_on(self, Ql: int, M: int, hier_s: int, sl: _Slot) -> bool:
        if self.hier is not None:
            return self.hier
        NW, _, T = sl.windows.shape
        return Ql * (M - hier_s) * NW * T >= plan.HIER_MIN_SAVED_PAIRS

    def _prefilter(self, sl: _Slot, pmq, S: int, k: int, eq_mode: str):
        """The suffix prefilter (reference ``sharded.py:282-331``): the
        tiles where the last ``S`` rows of any of the slot's patterns reach
        a cost <= k at an owned position, from the meta kernel's screen
        bit; the slot keeps those tiles alone (none: ``windows`` None).
        Exact: a row suffix never costs more than the whole pattern, and
        every owned position of a tile left out costs > k, so the state
        chain may run over the kept tiles as neighbours."""
        Ql = pmq.shape[0]
        dev = sl.windows.device
        T = sl.windows.shape[2]
        no_t0 = torch.zeros(T, dtype=torch.bool, device=dev)
        zeros = torch.zeros((Ql, S), dtype=torch.int32, device=dev)
        if Ql == 1:
            meta = myers_cuda.scan_meta(
                sl.windows, no_t0, sl.vf, sl.vt, pmq[0, -S:].contiguous(),
                zeros[0], torch.ones_like(zeros[0]), S, S, k, eq_mode)[3][None]
        else:
            s_vec = torch.full((Ql,), S, dtype=torch.int32, device=dev)
            meta = myers_cuda.scan_q_meta(
                sl.windows, no_t0, sl.vf, sl.vt, pmq[:, -S:].contiguous(),
                zeros, torch.ones_like(zeros), s_vec, s_vec, k, eq_mode)[3]
        ids = torch.nonzero(((meta & 1) != 0).any(dim=1).any(dim=0)).view(-1)
        if ids.numel() == 0:
            sl.windows = None
            return
        sl.windows = sl.windows.take(ids)
        sl.start, sl.vf, sl.vt, sl.il, sl.pos_base = (
            x[ids] for x in (sl.start, sl.vf, sl.vt, sl.il, sl.pos_base))

    @staticmethod
    def _scan(sl: _Slot, pmq, pad_t, hinit_t, m, boundary_m, m_q, bm_q, k,
              eq_mode, fast: bool) -> tuple:
        """The kernel over the slot's windows (read in place); outputs with
        a pattern axis: word level q1meta (one pattern) or q2meta, (vp, vm,
        cost, meta, final); position level q1 or q2, (vp, vm, cost)."""
        Ql = pmq.shape[0]
        if Ql == 1:
            if fast:
                outs = myers_cuda.scan_meta(
                    sl.windows, sl.start, sl.vf, sl.vt, pmq[0], pad_t,
                    hinit_t, m, boundary_m, k, eq_mode)
            else:
                outs = myers_cuda.scan(sl.windows, sl.start, pmq[0], pad_t,
                                       hinit_t, m, boundary_m, eq_mode)
            return tuple(o[None] for o in outs)
        pad_q = pad_t.expand(Ql, -1).contiguous()
        hinit_q = hinit_t.expand(Ql, -1).contiguous()
        if fast:
            return myers_cuda.scan_q_meta(
                sl.windows, sl.start, sl.vf, sl.vt, pmq, pad_q, hinit_q,
                m_q, bm_q, k, eq_mode)
        return myers_cuda.scan_q(sl.windows, sl.start, pmq, pad_q, hinit_q,
                                 m_q, bm_q, eq_mode)

    @staticmethod
    def _select_words(sl: _Slot, prev, k: int, all_minima: bool):
        """Word-level selection of the slot, the state chain seeded by the
        shards before it (reference ``sharded.py:361-388``). Returns (3, N)
        int64 [slot-local pattern; end position; cost]."""
        final = sl.outs[4]
        seed = torch.where(prev > 0, 2 + (prev & 1), 0).to(
            device=final.device, dtype=torch.int32)[:, None]
        cols, _ = minima.select_words_chained(
            *sl.outs, sl.start, seed, sl.vf, sl.vt, sl.il, sl.pos_base, k,
            all_minima)
        return cols[[0, 2, 3]]

    @staticmethod
    def _select_positions(sl: _Slot, prev, bm: int, n: int, max_pos: int,
                          k: int, alpha, all_minima: bool):
        """Position-level selection of each of the slot's patterns over its
        owned range, seeded by the shards before it (reference
        ``sharded.py:439-484``). Returns (3, N) int64 as
        ``_select_words``."""
        vp, vm, cost = sl.outs
        found = []
        for q in range(vp.shape[0]):
            st0 = None if all_minima else int(prev[q] & 1 if prev[q] else 0)
            got = minima.select_candidates(
                vp[q], vm[q], cost[q], sl.W, sl.halo, bm, n - sl.offset,
                max_pos - sl.offset, k, alpha, all_minima,
                min_pos=sl.min_pos, owned_end=sl.owned_end, state0=st0)
            found.append(torch.cat([torch.full_like(got[:1], q),
                                    got[:1] + sl.offset, got[1:]]))
        return torch.cat(found, 1)

    # -- every rank's result ----------------------------------------------
    def _gather(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's (4, N) [slot; pattern; end; cost] columns on the
        host: the counts first, then the columns padded to the largest."""
        mesh = self.mesh
        if not mesh.distributed:
            return local.cpu()
        size = torch.tensor([local.shape[1]], device=local.device)
        sizes = _all_gather(size, mesh).view(-1).tolist()
        pad = max(sizes) - local.shape[1]
        if pad:
            local = torch.cat([local, local.new_full((4, pad), -1)], 1)
        every = _all_gather(local, mesh).cpu()
        return torch.cat([every[r, :, :c] for r, c in enumerate(sizes)], 1)

    def _results(self, got: np.ndarray, Q, Ql, S, Dt, Dp, max_pos,
                 fast: bool) -> list[list[tuple]]:
        """The per-pattern lists and ``last_stats`` (reference
        ``sharded.py:614-691``): the word-level path counts per (pattern
        group, shard) as the reference's joint kernel layout does, the
        position-level path per (pattern, shard); both count the real
        patterns only, not the repeats that pad the pattern axis."""
        slot, q, pos, cost = got
        d = slot % Dt
        span = S * WB
        owner = np.where(pos <= 0, 0, (pos - 1) // span)
        words_all = max(1, cdiv(max_pos, WB))
        rows, ql = (Dp, Ql) if fast else (Q, 1)
        counts = np.zeros((rows, Dt), np.int64)
        np.add.at(counts, (q // ql, d), 1)
        self.last_stats = {
            "Dt": Dt,
            "Dp": Dp if fast else 1,
            "Qlocal": ql,
            "S": S,
            "owned_words": [max(0, min(words_all - i * S, S))
                            for i in range(Dt)],
            "per_shard_counts": counts,
            "ownership_violations": int((owner != d).sum()),
        }
        results: list[list[tuple]] = [[] for _ in range(Q)]
        order = np.lexsort((cost, pos, q))
        for qq, pp, cc in zip(q[order].tolist(), pos[order].tolist(),
                              cost[order].tolist()):
            results[qq].append((pp, cc))
        return results
