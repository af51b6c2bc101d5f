"""The reference's answer over chosen areas of the texts.

An area is a range of end positions [lo, hi] of one text (forward
coordinates), with the patterns it is checked for. On each strand the DP
runs from ``MARGIN_EXTRA`` + 2m characters before the area (or from the
text's start) to its end, so every cost from 2m characters on is exact: a
best alignment spans at most 2m characters, since m substitutions align
any pattern. Whether the scan is falling at a position depends on the
costs before it only back to the last change, so an area is checked from
the first change after the exact costs begin; at the text's start it is
exact from 0. ``search_areas`` returns the matches found and the ranges
checked, so that the program's matches in exactly those ranges can be
held to them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import dp

__all__ = ["Area", "search_areas", "MARGIN_EXTRA"]

#: exact costs begin 2m characters into a DP; the margin adds this many
#: more, in which the scan's state is found
MARGIN_EXTRA = 64


@dataclass(frozen=True)
class Area:
    """End positions ``lo..hi`` (forward coordinates, both included) of
    text ``text``, checked for the patterns ``patterns`` (None: all) on
    the strands ``strands`` (0 forward, 1 reverse)."""

    text: int
    lo: int
    hi: int
    patterns: tuple | None = None
    strands: tuple = (0, 1)


def search_areas(patterns, texts, k: int, areas, device,
                 max_cells: int = 1 << 26):
    """The reference's matches in ``areas``.

    ``patterns``, ``texts``: uint8 byte arrays. Returns ``(found,
    checked)``: the set of match tuples (pattern, text, strand, start, end,
    pattern start, pattern end, cost, CIGAR) in forward coordinates, and
    the checked ranges, an int64 array of rows (text, strand, pattern, lo,
    hi) in the strand's coordinates (the reverse strand's end e is the
    forward start n - e). ``max_cells``: the most DP cells one block of
    lanes holds in a row."""
    pcodes = [dp.encode(p) for p in patterns]
    ccodes = [dp.encode(dp.complement(p)) for p in patterns]
    # segments: one area on one strand; lanes: a segment and a pattern
    segs, lanes = [], []
    for ar in areas:
        n = len(texts[ar.text])
        qs = range(len(patterns)) if ar.patterns is None else ar.patterns
        for s in ar.strands:
            lo, hi = (ar.lo, ar.hi) if s == 0 else (n - ar.hi, n - ar.lo)
            segs.append((ar.text, s, lo, hi))
            lanes.extend((len(segs) - 1, q) for q in qs)
    seg = np.array(segs, np.int64).reshape(-1, 4)
    lane = np.array(lanes, np.int64).reshape(-1, 2)
    plen = np.array([len(p) for p in patterns], np.int64)
    nlen = np.array([len(t) for t in texts], np.int64)
    m = plen[lane[:, 1]]
    t, s, lo, hi = (seg[lane[:, 0], i] for i in range(4))
    n = nlen[t]
    a = np.maximum(0, lo - 2 * m - MARGIN_EXTRA)
    b = np.minimum(n, hi + 1)
    order = np.lexsort((b - a, m))
    checked, ends = [], []
    i = 0
    while i < len(order):
        mi = m[order[i]]
        j = i + 1
        while (j < len(order) and m[order[j]] == mi
               and (j - i + 1) * (b[order[j]] - a[order[j]] + 1) <= max_cells):
            j += 1
        rows = order[i:j]
        _block(rows, int(mi), pcodes, ccodes, texts, k, device, lane, t, s,
               lo, hi, n, a, b, checked, ends)
        i = j
    found = set(_trace(pcodes, ccodes, texts, k, ends, device))
    return found, np.array(checked, np.int64).reshape(-1, 5)


def _block(rows, m, pcodes, ccodes, texts, k, device, lane, t, s, lo, hi,
           n, a, b, checked, ends) -> None:
    """The DP of one block of lanes of pattern length ``m``, and its ends,
    on ``device``: appends the block's checked ranges to ``checked`` and
    its reported ends, (text, strand, pattern, end), to ``ends``."""
    t, s, lo, hi, n, a, b = (x[rows] for x in (t, s, lo, hi, n, a, b))
    q = lane[rows, 1]
    L = b - a
    width = int(L.max())
    keys = {}
    seg_of = np.empty(len(rows), np.int64)
    for r, key in enumerate(zip(t.tolist(), s.tolist(), a.tolist(),
                                b.tolist())):
        seg_of[r] = keys.setdefault(key, len(keys))
    tseg = np.zeros((len(keys), width), np.uint8)
    for (ti, si, ai, bi), g in keys.items():
        tseg[g, :bi - ai] = _strand_codes(texts[ti], si, ai, bi)
    pc = np.stack([(pcodes if si == 0 else ccodes)[qi]
                   for si, qi in zip(s.tolist(), q.tolist())])
    dev = torch.device(device)
    tc = torch.from_numpy(tseg).to(dev)[torch.from_numpy(seg_of).to(dev)]
    c = dp.last_row(torch.from_numpy(pc).to(dev), tc)
    del tc
    rep, falling = dp.report_ends(c, k)

    def col(x):
        return torch.from_numpy(np.asarray(x)).to(dev)[:, None]

    pos = torch.arange(width + 1, device=dev)
    Lc = col(L)
    # the first change in the exact costs, where the scan's state is known
    change = torch.zeros_like(rep)
    change[:, 1:] = c[:, 1:] != c[:, :-1]
    change &= (pos >= 2 * m + 1) & (pos <= Lc)
    first = torch.where(col(a)[:, 0] == 0, 0,
                        change.to(torch.int8).argmax(dim=1)).cpu().numpy()
    ok = (a == 0) | change.any(dim=1).cpu().numpy()
    lo_c = np.maximum(lo, a + first)
    top = np.where(b == n, hi, np.minimum(hi, b - 1))
    ok &= lo_c <= top
    hit = rep & col(ok) & (pos >= col(lo_c - a)) & (pos <= col(top - a))
    # the text's last position: reported when the scan ends falling
    last = (col(ok & (b == n) & (top == n)) & (pos == Lc) & falling
            & (c <= k))
    hit |= last
    checked.extend(np.stack([t, s, q, lo_c, top], axis=1)[ok].tolist())
    r, x = (v.cpu().numpy() for v in torch.nonzero(hit, as_tuple=True))
    ends.extend(zip(t[r].tolist(), s[r].tolist(), q[r].tolist(),
                    (a[r] + x).tolist()))


def _strand_codes(text: np.ndarray, strand: int, a: int, b: int) -> np.ndarray:
    """Codes of characters a..b-1 of the strand's text (the reverse strand
    reads the forward bytes backwards)."""
    n = len(text)
    seg = text[a:b] if strand == 0 else text[n - b:n - a][::-1]
    return dp.encode(seg)


def _trace(pcodes, ccodes, texts, k: int, ends, device):
    """Each end's match tuple: the window of the m + k characters before
    it, its DP filled again, the walk."""
    groups: dict = {}
    for t, s, q, e in set(ends):
        m = len(pcodes[q])
        groups.setdefault((m, min(e, m + k)), []).append((t, s, q, e))
    for (m, w), rows in groups.items():
        tc = np.zeros((len(rows), w), np.uint8)
        pc = np.zeros((len(rows), m), np.uint8)
        for r, (t, s, q, e) in enumerate(rows):
            tc[r] = _strand_codes(texts[t], s, e - w, e)
            pc[r] = (pcodes if s == 0 else ccodes)[q]
        D = dp.full_matrices(torch.from_numpy(pc).to(device),
                             torch.from_numpy(tc).to(device)).cpu().tolist()
        for r, (t, s, q, e) in enumerate(rows):
            i, cost, cigar = dp.walk(pc[r].tolist(), tc[r].tolist(), D[r])
            start, end = e - w + i, e
            if s == 1:
                n = len(texts[t])
                start, end = n - end, n - start
            yield (q, t, s, start, end, 0, m, cost, cigar)
