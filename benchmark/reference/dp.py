"""The search, written out plainly: the DP, the match ends, the traceback.

For a pattern P of m IUPAC characters and a text T, ``D[j, i]`` is the
least edit cost of aligning P[:j] to a suffix of T[:i]:

    D[0, i] = 0                 (a match may start anywhere in the text)
    D[j, 0] = j
    D[j, i] = min(D[j-1, i-1] + (P[j-1] !~ T[i-1]),    (match or substitution)
                  D[j-1, i] + 1,                        (a pattern character left over)
                  D[j, i-1] + 1)                        (a text character left over)

where ``p ~ t`` holds when the two IUPAC base sets share a base. The match
ends are the rightmost local minima of the last row ``c[i] = D[m, i]`` with
cost <= k (``report_ends_scalar`` gives the rule). Each end is traced back
over the window of the m + k text characters before it: the DP is filled
again over that window alone, and a greedy walk from (m, window end)
prefers a match, then a substitution, a text character left over (D) and
a pattern character left over (I) (``walk``).

The reverse strand is the complemented pattern searched in the reversed
text; its coordinates map back as ``start = n - end'``, ``end = n - start'``
and its CIGAR stays as the walk gives it.

The DP runs row by row in PyTorch on whatever device its tensors are on: a
row is a minimum over the row above and a running minimum along the text
(``D[j, i] - i`` is a running minimum of the row's other two terms less
``i``), so one row is a few whole-tensor operations over every lane.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["CODES", "COMPLEMENT", "encode", "complement", "last_row",
           "full_matrices", "report_ends_scalar", "report_ends", "walk",
           "cigar_string"]

_A, _C, _G, _T = 1, 2, 4, 8
_SETS = {
    "A": _A, "C": _C, "G": _G, "T": _T, "U": _T,
    "R": _A | _G, "Y": _C | _T, "S": _C | _G, "W": _A | _T,
    "K": _G | _T, "M": _A | _C, "B": _C | _G | _T, "D": _A | _G | _T,
    "H": _A | _C | _T, "V": _A | _C | _G, "N": _A | _C | _G | _T,
}
_PAIRS = {"A": "T", "C": "G", "G": "C", "T": "A", "U": "A", "R": "Y",
          "Y": "R", "S": "S", "W": "W", "K": "M", "M": "K", "B": "V",
          "V": "B", "D": "H", "H": "D", "N": "N"}

#: a byte's IUPAC base set, one bit a base; 0 for a byte that is no code
CODES = np.zeros(256, np.uint8)
#: a byte's complement (identity for a byte that is no code)
COMPLEMENT = np.arange(256, dtype=np.uint8)
for _ch, _bits in _SETS.items():
    for _c in (_ch, _ch.lower()):
        CODES[ord(_c)] = _bits
for _a, _b in _PAIRS.items():
    COMPLEMENT[ord(_a)] = ord(_b)
    COMPLEMENT[ord(_a.lower())] = ord(_b.lower())


def encode(seq: np.ndarray) -> np.ndarray:
    """The base sets of a uint8 byte array."""
    return CODES[np.asarray(seq, np.uint8)]


def complement(seq: np.ndarray) -> np.ndarray:
    """The complement of each byte (not reversed)."""
    return COMPLEMENT[np.asarray(seq, np.uint8)]


def _rows(pcodes: torch.Tensor, tcodes: torch.Tensor):
    """Yield the DP's rows 0..m, each (lanes, L + 1) int32, of each lane's
    pattern codes (lanes, m) over its text codes (lanes, L)."""
    lanes, m = pcodes.shape
    L = tcodes.shape[1]
    dev = tcodes.device
    idx = torch.arange(L + 1, dtype=torch.int32, device=dev)
    row = torch.zeros(lanes, L + 1, dtype=torch.int32, device=dev)
    yield row
    base = torch.empty_like(row)
    for j in range(1, m + 1):
        miss = ((pcodes[:, j - 1:j] & tcodes) == 0).to(torch.int32)
        base[:, 0] = j
        torch.minimum(row[:, :-1] + miss, row[:, 1:] + 1, out=base[:, 1:])
        row = torch.cummin(base - idx, dim=1).values + idx
        yield row


def last_row(pcodes: torch.Tensor, tcodes: torch.Tensor) -> torch.Tensor:
    """(lanes, L + 1) int32: ``D[m, i]`` of each lane for i = 0..L."""
    row = None
    for row in _rows(pcodes, tcodes):
        pass
    return row


def full_matrices(pcodes: torch.Tensor, tcodes: torch.Tensor) -> torch.Tensor:
    """(lanes, m + 1, L + 1) int32: each lane's whole DP."""
    return torch.stack(list(_rows(pcodes, tcodes)), dim=1)


def report_ends_scalar(c, k: int, at_text_end: bool = True) -> list[int]:
    """The ends that the search reports from a last row ``c[0..P]``, one
    position at a time: the scan starts falling; a position is reported
    when the costs turn from falling (or level since they fell) to rising
    and its cost is <= k, and the last position when the scan ends falling
    with a cost <= k (``at_text_end``: ``c`` ends at the text's end)."""
    out = []
    falling = True
    P = len(c) - 1
    for p in range(1, P + 1):
        if falling and c[p] > c[p - 1] and c[p - 1] <= k:
            out.append(p - 1)
        falling = c[p] < c[p - 1] or (falling and c[p] == c[p - 1])
    if at_text_end and falling and c[P] <= k:
        out.append(P)
    return out


def report_ends(c: torch.Tensor, k: int):
    """``report_ends_scalar`` over the rows of ``c`` (lanes, P + 1) at
    once, without the rule of the text's last position: the (lanes, P + 1)
    bool mask of the positions reported where the costs turn to rising, and
    the mask of the positions after which the scan is falling.

    After position p the scan is falling when the level run holding p
    starts at 0 or starts below the cost before it."""
    idx = torch.arange(c.shape[1], device=c.device)
    start = torch.ones(c.shape, dtype=torch.bool, device=c.device)
    start[:, 1:] = c[:, 1:] != c[:, :-1]
    run0 = torch.cummax(torch.where(start, idx, 0), dim=1).values
    before = torch.gather(c, 1, (run0 - 1).clamp(min=0))
    falling = (run0 == 0) | (before > c)
    out = torch.zeros_like(start)
    out[:, :-1] = (c[:, :-1] <= k) & (c[:, 1:] > c[:, :-1]) & falling[:, :-1]
    return out, falling


def walk(p, t, D) -> tuple[int, int, str]:
    """The greedy backwards walk over one window's DP ``D`` (m + 1 rows of
    w + 1) of pattern codes ``p`` (m) against window codes ``t`` (w), from
    (m, w). Returns (start in the window, cost, CIGAR in pattern order).
    Any indexable rows serve; lists are the quickest."""
    m, w = len(p), len(t)
    j, i = m, w
    g = int(D[m][w])
    cost = g
    ops = []
    while j > 0:
        if i > 0 and D[j - 1][i - 1] == g and int(p[j - 1]) & int(t[i - 1]):
            ops.append("=")
            j, i = j - 1, i - 1
            continue
        g -= 1
        if i > 0 and D[j - 1][i - 1] == g:
            ops.append("X")
            j, i = j - 1, i - 1
        elif i > 0 and D[j][i - 1] == g:
            ops.append("D")
            i -= 1
        elif D[j - 1][i] == g:
            ops.append("I")
            j -= 1
        else:
            raise ValueError(f"no step back from ({j}, {i}) at cost {g + 1}")
    if g != 0:
        raise ValueError(f"the walk ended at cost {g}, not 0")
    ops.reverse()
    return i, cost, cigar_string(ops)


def cigar_string(ops) -> str:
    """Run-length form of a list of op characters: '3=1X20='."""
    out = []
    n = 0
    for a, b in zip(ops, ops[1:] + [None]):
        n += 1
        if a != b:
            out.append(f"{n}{a}")
            n = 0
    return "".join(out)
