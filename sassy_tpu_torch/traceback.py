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
"""

from __future__ import annotations

import numpy as np

from .cigar import DEL, INS, MATCH, SUB, Cigar
from .matchrec import Match, Strand
from .oracle import dp_matrix
from .profiles import Profile, as_bytes_array
from .semantics import overshoot_cost

__all__ = ["trace_candidate", "trace_candidates_batch", "TraceError"]


class TraceError(RuntimeError):
    """Raised when no backward step is consistent — the reference panics here
    with an invalid-alphabet hint (trace.rs:367-387)."""


def _fill_batch(
    profile: Profile,
    pattern_codes: np.ndarray,
    wins: np.ndarray,  # (B, w) engine codes, right-padded
    alpha: float | None,
    max_overhang: int | None,
) -> np.ndarray:
    """Batched windowed DP fill: one vectorized pass over all B windows.

    The role of the reference's ``simd_fill`` (trace.rs:107-178): candidate
    windows are re-filled together so the fill cost amortizes over the
    batch instead of paying the per-row dispatch overhead per candidate.
    Right-padding is harmless — each candidate's walk only reads columns
    up to its own window length.
    """
    from .semantics import left_boundary_costs

    B, w = wins.shape
    m = len(pattern_codes)
    boundary = left_boundary_costs(m, alpha, max_overhang)
    # (m, B*w) -> (B, m, w)
    mm = (
        profile.match_mask(pattern_codes, wins.reshape(-1))
        .reshape(m, B, w)
        .transpose(1, 0, 2)
    )
    D = np.zeros((B, m + 1, w + 1), dtype=np.int64)
    D[:, :, 0] = boundary[None, :]
    idx = np.arange(w + 1, dtype=np.int64)
    base = np.empty((B, w + 1), dtype=np.int64)
    for j in range(1, m + 1):
        prev = D[:, j - 1]
        base[:, 0] = boundary[j]
        np.minimum(prev[:, :-1] + (1 - mm[:, j - 1]), prev[:, 1:] + 1,
                   out=base[:, 1:])
        D[:, j] = np.minimum.accumulate(base - idx, axis=1) + idx
    return D, mm


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
    """Re-align and trace a batch of candidate end positions in ONE fill.

    The reference's ``process_matches`` batches LANES candidates per
    ``simd_fill`` (search.rs:1372-1689, trace.rs:107-178); here the batch is
    all candidates of the (pattern, text) pair — the windowed DP matrices
    are computed together (vectorized over the batch axis), then each
    candidate's greedy walk reads its own precomputed matrix.
    """
    if not ends:
        return []
    m = len(pattern)
    n = len(text)
    w = fill_len
    B = len(ends)
    wins = np.full((B, w), profile.pad_code, dtype=np.uint8)
    offsets = []
    wlens = []
    for b, end_pos in enumerate(ends):
        offset = max(0, end_pos - fill_len)
        win_end = min(end_pos, n)
        wl = win_end - offset
        # encode per-window: encoding the whole text here would cost
        # O(n) per (pattern, text) pair at genome scale
        wins[b, :wl] = profile.encode(text[offset:win_end])
        offsets.append(offset)
        wlens.append(wl)
    D, mm = _fill_batch(profile, pattern_codes, wins, alpha, max_overhang)
    return _walk_batch(
        profile, pattern, text, D, mm, ends, offsets, wlens, alpha,
        max_overhang,
    )


def _walk_batch(
    profile: Profile,
    pattern: np.ndarray,
    text: np.ndarray,
    D: np.ndarray,  # (B, m+1, w+1) windowed cost matrices
    mm: np.ndarray,  # (B, m, w) match mask (pattern row x window col)
    ends: list[int],
    offsets: list[int],
    wlens: list[int],
    alpha: float | None,
    max_overhang: int | None,
) -> list[Match]:
    """Vectorized greedy walks: ALL candidates step together.

    Each iteration advances every still-active candidate by one op,
    chosen with the reference's fixed preference (=, X, D, I —
    trace.rs:338-365) from four vectorized matrix gathers; op codes are
    recorded per step and run-length-encoded into Cigars at the end.
    Replaces the per-candidate Python walk that cost ~44 us/candidate
    (is_match + push dominating) — the walk itself is now O(path length)
    numpy passes over the whole batch.
    """
    from .semantics import overshoot_costs_vec

    B = len(ends)
    m = len(pattern)
    w = D.shape[2] - 1
    stride = w + 1
    ar = np.arange(B)
    Dv = D.reshape(B, -1)
    mmv = mm.reshape(B, -1) if m else np.zeros((B, 0), np.uint8)
    ends_a = np.asarray(ends, dtype=np.int64)
    off_a = np.asarray(offsets, dtype=np.int64)
    wl_a = np.asarray(wlens, dtype=np.int64)

    # end overshoot: walk straight back along the virtual 'N' diagonal
    i = ends_a - off_a
    over = np.maximum(i - wl_a, 0)
    pat_end = m - over
    i = i - over
    j = np.full(B, m, dtype=np.int64) - over
    g = Dv[ar, j * stride + i]
    total = g + overshoot_costs_vec(alpha, over)
    pat_start = np.zeros(B, dtype=np.int64)

    S = m + w + 1
    ops = np.full((B, S), -1, dtype=np.int8)
    act = j > 0
    alpha_on = alpha is not None
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
                if max_overhang is not None:
                    oc = np.floor(
                        np.minimum(jj, max_overhang).astype(np.float32)
                        * np.float32(alpha)
                    ).astype(np.int64) + np.maximum(0, jj - max_overhang)
                else:
                    oc = np.floor(
                        jj.astype(np.float32) * np.float32(alpha)
                    ).astype(np.int64)
                pat_start[stop0] = jj
                g[stop0] -= oc
                act = act & ~stop0
                if not act.any():
                    break
        jm1 = np.maximum(j - 1, 0)
        im1 = np.maximum(i - 1, 0)
        d_diag = Dv[ar, jm1 * stride + im1]
        d_left = Dv[ar, j * stride + im1]
        d_up = Dv[ar, jm1 * stride + i]
        mat = mmv[ar, jm1 * w + im1] != 0 if m and w else np.zeros(B, bool)
        can_i = i > 0
        is_m = act & can_i & (d_diag == g) & mat
        g1 = g - 1
        rest = act & ~is_m
        is_s = rest & can_i & (d_diag == g1)
        rest = rest & ~is_s
        is_d = rest & can_i & (d_left == g1)
        rest = rest & ~is_d
        is_i = rest & (d_up == g1)
        newbad = rest & ~is_i
        if newbad.any():
            # defer: re-run those through the scalar walk for the exact
            # reference-style diagnostics
            bad |= newbad
            act = act & ~newbad
        ops[:, step] = np.select(
            [is_m, is_s, is_d, is_i], [0, 1, 2, 3], default=-1
        ).astype(np.int8)
        g = np.where(is_m | ~act, g, g1)
        j = j - (is_m | is_s | is_i)
        i = i - (is_m | is_s | is_d)
        act = act & (j > 0)
        step += 1

    if bad.any() or (g[~bad] != 0).any():
        # exact per-candidate errors via the scalar walk
        for b in np.nonzero(bad | (g != 0))[0]:
            wtext = text[offsets[b] : offsets[b] + wlens[b]]
            _walk(
                profile, pattern, wtext, D[b], ends[b], offsets[b],
                wlens[b], alpha, max_overhang,
            )
        raise TraceError("vectorized walk failed but scalar walk passed")

    # run-length encode each candidate's (reversed) op sequence into a
    # Cigar. Valid ops form a contiguous prefix of each row; tag values
    # with the row id so runs cannot span rows, then one np.nonzero pass
    # yields every (row, op, length) run.
    opsl = ops[:, :step] if step else ops[:, :0]
    out: list[Match] = []
    if step:
        tagged = opsl.astype(np.int64) + (ar[:, None] << 8)
        flat = tagged.reshape(-1)
        chg = np.ones(flat.shape[0], dtype=bool)
        chg[1:] = flat[1:] != flat[:-1]
        starts = np.nonzero(chg)[0]
        lens = np.diff(np.append(starts, flat.shape[0]))
        rvals = opsl.reshape(-1)[starts]
        keep = rvals >= 0
        starts, lens, rvals = starts[keep], lens[keep], rvals[keep]
        rows = starts // max(step, 1)
        # runs are emitted in walk order (backwards); Cigar reads forward
        op_chars = (MATCH, SUB, DEL, INS)
        per_row: list[list[tuple[str, int]]] = [[] for _ in range(B)]
        for r, v, ln in zip(rows.tolist(), rvals.tolist(), lens.tolist()):
            per_row[r].append((op_chars[v], ln))
        for b in range(B):
            per_row[b].reverse()
    else:
        per_row = [[] for _ in range(B)]
    for b in range(B):
        out.append(
            Match(
                pattern_idx=0,
                text_idx=0,
                cost=int(total[b]),
                text_start=int(off_a[b] + i[b]),
                text_end=int(off_a[b] + wl_a[b]),
                pattern_start=int(pat_start[b]),
                pattern_end=int(pat_end[b]),
                strand=Strand.FWD,
                cigar=Cigar(ops=per_row[b]),
            )
        )
    return out


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
