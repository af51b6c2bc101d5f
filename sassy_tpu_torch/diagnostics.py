"""Diagnostics and profiling on the port's device: the reference's
`sassy test` (features and a throughput smoke, lib.rs:187-281), a
profiler trace, and the least time the H100 could take for a scan, a
selection or a text pack.

The port's counterpart of ``sassy_tpu/diagnostics.py``: ``self_test``
runs the port's ``Searcher`` on ``device``, ``trace`` records a
``torch.profiler`` Chrome trace, and ``cost_model`` is the H100 bound of
``PERF.md`` section 6 (the reference's is a TPU's).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np

from .ops.bitpack import WORD_BITS
from .ops.plan import _bucket_rows, cdiv, halo_words, plan_tiles

__all__ = ["self_test", "trace", "cost_model", "scan_bound", "select_bound",
           "pack_bound", "trace_bound", "MEM_BYTES_PER_S", "INT32_OPS_PER_S",
           "ROW_OPS", "WORD_OPS"]

#: The least time of a scan kernel: the larger of its bytes over the
#: H100's 3.35 TB/s and its integer ALU-pipe instructions over that pipe's
#: rate, 132 SMs x 64 lanes x 1.98 GHz (the SXM part's boost clock; half
#: the issue rate, while IMAD issues to the FMA pipe and the U*
#: instructions to the uniform datapath). ROW_OPS, per (pattern row,
#: window word): the ALU-pipe instructions of scan_rows' loop
#: (csrc/myers_step.cuh) in the SASS nvcc 12.8 builds for sm_90a, counted
#: by `python -m sassy_tpu_torch.tools.sass_count`, the largest over q1meta,
#: q2meta and q2 and both carry layouts; q1's loop is within 0.75 of them
#: (all instructions per row: pure 33.5, iupac 28.75, ascii 34.75). A count
#: from the source, two bitwise operations on three inputs taken as one
#: LOP3, gave pure 21, iupac 23, ascii 28. WORD_OPS, per (pattern, window
#: word) outside the rows, from the source: the two popcounts and the cost
#: update (4), with the selection metadata also the owned mask, state code
#: and screen (20 more); the ablations keep one popcount and one add (2).
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ROW_OPS = {"pure": 24.25, "iupac": 22.75, "ascii": 27.25}
WORD_OPS = {False: 4, True: 24}


def scan_bound(eq_mode: str, Q: int, M: int, windows_shape, meta: bool,
               vp_only: bool = False) -> dict:
    """bound_ms and bound_by of one scan launch: Q patterns of M rows
    (pad rows included: the kernel scans them) over (NW, P, T) windows.
    Bytes: the windows read once, the outputs written once (vp, vm, cost
    and, with meta, meta and final; ``vp_only``: the ablations' one word
    per window word, and no text-start flags). The four search-path
    kernels read the windows in place, from the planes through each
    tile's descriptor: the same NW x P x T words are counted (the halo
    words a neighbour also reads included), so the work and the shares
    compare with those of the kernels that read window tensors."""
    NW, P, T = windows_shape
    word_ops = 2 if vp_only else WORD_OPS[meta]
    n_out = 1 if vp_only else 4 if meta else 3
    ops = Q * NW * T * (M * ROW_OPS[eq_mode] + word_ops)
    nbytes = 4 * (NW * P * T + Q * NW * T * n_out
                  + (Q * T if meta else 0)) + (0 if vp_only else T)
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def select_bound(entry: str, args: tuple, kwargs: dict, n_out: int) -> dict:
    """bound_ms and bound_by (and the bytes and ops they come from) of one
    call of a selection entry point of
    ``ops/minima.py`` (``select_words_tiles_q``, ``select_candidates``,
    ``select_candidates_tiles``, ``select_candidates_chained``,
    ``select_words_chained``) with these arguments, which returned
    ``n_out`` candidates. Bytes: what the function must read, once, and
    its int64 output columns; where that depends on the data, this call's
    data.

    - Word level: every meta word; vp, vm and cost of each screened word
      and, unless ``all_minima``, vp and vm of the other words of its
      ``n_prev`` strip that lie past valid_from; the tile tables
      (valid_from, valid_to, islast_at, pos_base, text_end) of the tiles
      with a screened word and, unless ``all_minima``, ``state0`` of the
      (pattern, tile) pairs with one; chained (``select_words_chained``),
      unless ``all_minima``, every ``final`` code and ``is_start`` flag
      (the chain's inputs) instead of ``state0``, and the carry in and
      out.
      The next word's first delta is read only for a candidate pending at
      a word's end, and is not counted.
    - Position level: vp and vm of every word that holds a position the
      function reports or whose delta feeds the state (one text: flat
      positions up to ``max_pos`` and ``owned_end``, from ``min_pos`` with
      an incoming state or ``all_minima``; pieces: window positions in
      (valid_from, valid_to]), and one cost a tile (the cost at a tile's first such
      word; each next word's is that plus popc(vp) - popc(vm)); pieces
      also read their tables, boundary0 where they own position 0, and
      ``state0`` unless ``all_minima``; chained
      (``select_candidates_chained``), ``is_start`` unless
      ``all_minima`` instead of ``state0``, and the carry in and out.

    Operations: one integer operation per position examined (each is held
    against k): one per (pattern, word, tile) and 32 per screened or
    strip word (33 for a screened one), or every position of the words
    above."""
    import inspect

    import torch

    from .ops import minima

    if entry not in ("select_words_tiles_q", "select_words_chained",
                     "select_candidates", "select_candidates_tiles",
                     "select_candidates_chained"):
        raise ValueError(f"no selection entry point {entry!r}")
    sig = inspect.signature(getattr(minima, entry + "_plain"))
    a = sig.bind(*args, **kwargs)
    a.apply_defaults()
    a = a.arguments
    state = not a["all_minima"]
    if entry in ("select_words_tiles_q", "select_words_chained"):
        meta = a["meta"]
        scr = (meta & 1) != 0
        screened = int(scr.sum())
        strip = torch.zeros_like(scr)
        if state:
            # the n_prev words before a screened word, less those wholly at
            # or below valid_from (their deltas never feed the state)
            for s in range(1, min(a["n_prev"], scr.shape[1] - 1) + 1):
                strip[:, :-s] |= scr[:, s:]
            w = torch.arange(scr.shape[1], device=scr.device)
            vf = a["valid_from"].to(torch.int64).div(
                WORD_BITS, rounding_mode="floor")
            strip &= ~scr & (w[:, None] >= vf[None, :])[None]
        n_strip = int(strip.sum())
        tiles = int(scr.any(dim=1).any(dim=0).sum())
        if entry == "select_words_tiles_q":
            seeds = 4 * int(scr.any(dim=1).sum()) if state else 0
            chain = 0
        else:  # the chain: final, is_start; the carry in and out
            Q, T = a["final"].shape
            chain = Q * T if state else 0
            seeds = (4 * Q * T + T if state else 0) + 8 * Q
        nbytes = (4 * meta.numel() + 12 * screened + 8 * n_strip
                  + tiles * (20 + (8 if a["text_end"] is not None else 0))
                  + seeds + 32 * n_out)
        ops = meta.numel() + 33 * screened + WORD_BITS * n_strip + chain
    elif entry == "select_candidates":
        T, W = a["vp_w"].shape[1], a["W"]
        hi = a["max_pos"]
        if a["owned_end"] is not None:
            hi = min(hi, a["owned_end"])
        gated = a["state0"] is not None or not state
        lo = max(1, a["min_pos"] or 0) if gated else 1
        # flat word j holds positions 32 j + 1 .. 32 j + 32
        first = (lo - 1) // WORD_BITS
        last = min(T * W - 1, (hi - 1) // WORD_BITS)
        words = max(0, last - first + 1)
        tiles = max(0, last // W - first // W + 1) if words else 0
        nbytes = 8 * words + 4 * tiles + 16 * n_out
        ops = words * WORD_BITS + 1
    else:
        Q, NW, T = a["vp_w"].shape
        vf = a["valid_from"].to(torch.int64)
        vt = a["valid_to"].to(torch.int64)
        # window word w holds positions 32 w + 1 .. 32 w + 32
        first = vf.clamp(min=0) // WORD_BITS
        last = torch.minimum((vt - 1).div(WORD_BITS, rounding_mode="floor"),
                             torch.full_like(vt, NW - 1))
        nw = torch.where(vt > vf.clamp(min=0), last - first + 1, 0).clamp(
            min=0)
        own0 = (vf < 0) & (vt >= 0)
        live = int(((nw > 0) | own0).sum())
        words = int(nw.sum())
        if entry == "select_candidates_tiles":
            seeds = 4 * Q * live if state else 0
        else:  # the chain: is_start, the carry in and out
            seeds = (live if state else 0) + 8 * Q
        nbytes = (Q * (8 * words + 4 * int((nw > 0).sum())
                       + 4 * int(own0.sum())) + seeds
                  + live * (20 + (8 if a["alpha"] else 0)) + 32 * n_out)
        ops = Q * (words * WORD_BITS + int(own0.sum()))
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "ops": ops}


def pack_bound(n_bytes: int, planes: int, with_valid: bool,
               gw: int | None = None, texts: int = 0) -> dict:
    """bound_ms and bound_by (and the bytes and ops they come from) of one
    text pack: ``n_bytes`` bytes read once and the (planes + with_valid,
    gw) int32 words written once (gw defaults to the words that hold the
    bytes), against one operation a byte (its code's lookup); with
    ``texts``, a text set's pack, whose tables (starts, lens and wofs:
    3 * texts + 1 int64) are read once too."""
    gw = cdiv(n_bytes, WORD_BITS) if gw is None else gw
    nbytes = (n_bytes + 4 * (planes + int(bool(with_valid))) * gw
              + (8 * (3 * texts + 1) if texts else 0))
    ops = n_bytes
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "ops": ops}


def trace_bound(cand: np.ndarray, out: np.ndarray, m: int, fill_len: int,
                planes: int, patterns: int) -> dict:
    """bound_ms and bound_by (and the bytes and ops they come from) of one
    traceback call (``myers_cuda.trace_windows``) over (5, B) int64
    candidate columns ``cand`` (pattern, first plane word, window offset,
    window length, end) that returned the (B, stride) int32 rows ``out``.
    Only what this call's data needs: a candidate's walk starts at column
    i0 = min(end - offset, window length) and row m - over (its end
    overshoot), and reads no column past i0.

    Bytes: the ``planes`` plane words that hold each window's first i0
    positions, read once; the candidate columns, the ``patterns`` x m
    pattern codes and the (3, m + 1) int32 tables, read once; the output
    rows, written once. Operations: one a DP cell of rows 1..m - over and
    columns 1..i0, and one a walk step (an op in ``out``)."""
    from .ops.myers_cuda import TRACE_FIELDS

    off, wlen, end = (np.asarray(cand[r], np.int64) for r in (2, 3, 4))
    base = 32 * np.asarray(cand[1], np.int64) + off
    over = np.maximum(end - off - wlen, 0)
    i0 = end - off - over
    words = np.where(i0 > 0, (base % 32 + i0 + 31) // 32, 0)
    steps = int(np.count_nonzero(
        np.ascontiguousarray(out[:, TRACE_FIELDS:]).view(np.int8) >= 0))
    nbytes = (4 * planes * int(words.sum()) + cand.size * 8
              + patterns * m + 12 * (m + 1) + out.size * 4)
    ops = int(((m - over) * i0).sum()) + steps
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "ops": ops}


def cost_model(m: int, n: int, k: int, num_patterns: int = 1,
               eq_mode: str = "pure") -> dict:
    """The H100 bound of the word-level scan (q1meta; q2meta's work for
    ``num_patterns`` > 1) of ``num_patterns`` patterns of length m at k
    over a text of n chars, on the single engine's tile plan: the windows
    ``TorchEngine.build_inputs`` makes for that text, without overhang."""
    M = _bucket_rows(m)
    T, W, halo = plan_tiles(max(1, cdiv(n, WORD_BITS)), halo_words(M, k))
    shape = (W + halo + 1, 9 if eq_mode == "ascii" else 4, T)
    b = scan_bound(eq_mode, num_patterns, M, shape, True)
    sol_seconds = b["bound_ms"] / 1e3
    return {
        "dp_cells": n * m * num_patterns,
        "windows": shape,
        "rows": M,
        **b,
        "sol_seconds": sol_seconds,
        "sol_gbps": n * num_patterns / sol_seconds / 1e9,
    }


def self_test(text_bytes: int = 100_000, verbose: bool = True,
              device="cuda") -> dict:
    """The port's features and a 23 bp, k=1 throughput smoke on
    ``device`` (reference lib.rs:259-281)."""
    from . import features
    from .profiles import Iupac
    from .search import Searcher

    info = features()
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    text = rng.choice(bases, size=text_bytes)
    text.flags.writeable = False  # read-only: the engine caches its planes
    pattern = rng.choice(bases, size=23)
    s = Searcher(Iupac(), rc=False, device=device)
    s.search(pattern, text, 1)  # first launch; the text's planes stay cached
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        s.search(pattern, text, 1)
    dt = (time.perf_counter() - t0) / reps
    info["engine"] = ("cuda kernels" if s.device.type == "cuda"
                      else "plain PyTorch")
    info["search_device"] = str(s.device)
    info["throughput_gbps"] = text_bytes / dt / 1e9
    if verbose:
        for key, val in info.items():
            print(f"{key}: {val}")
    return info


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA where there is a device) and write it to
    ``log_dir/trace.json`` (Chrome trace format). Yields the profiler, for
    ``key_averages()``. The engines' device work runs on their dispatch
    thread, so every thread is recorded where this torch can; an older
    one records the CPU operators of the calling thread only."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        config = _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        config = None
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, experimental_config=config) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
