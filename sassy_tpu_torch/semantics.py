"""Shared search semantics: the overhang cost math.

These helpers define the overhang *contract* every engine must satisfy.
All float arithmetic deliberately uses float32 to reproduce the
reference's ``f32`` rounding:

- overhang steps:   ``min(m, ceil((k + alpha) / alpha), max_overhang)``
  (reference search.rs:347-356, ``get_overhang_steps``)
- overshoot cost:   ``floor(alpha * overshoot)``
  (reference search.rs:1274-1282, ``add_overshoot_cost``)
- left boundary:    ``floor(min(j, mo) * alpha) + max(0, j - mo)``
  (reference trace.rs:37-44 / search.rs:1692-1748 init deltas)

The port's own copy of ``sassy_tpu/semantics.py`` (the port imports nothing
of the JAX package); tests/test_torch_copies.py holds the two equal. The
engines select candidates on the device (``ops/minima.py``); the host
scans ``find_candidates_scalar`` / ``find_candidates`` serve the oracle
(``oracle.candidates``), which the differential soak
(``tools/soak.py``) holds the engines to.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "overhang_steps",
    "overshoot_cost",
    "left_boundary_costs",
    "overshoot_costs_vec",
    "init_h_deltas",
    "find_candidates_scalar",
    "find_candidates",
]


def overhang_steps(m: int, k: int, alpha: float | None, max_overhang: int | None) -> int:
    """How many positions past the text end can still host a match end."""
    if alpha is None:
        return 0
    with np.errstate(divide="ignore", invalid="ignore"):
        raw = np.ceil((np.float32(k) + np.float32(alpha)) / np.float32(alpha))
    # alpha == 0 gives inf; Rust's `as usize` saturates, so min(m, ..) == m.
    steps = m if not np.isfinite(raw) else min(m, int(raw))
    if max_overhang is not None:
        steps = min(steps, max_overhang)
    return steps


def overshoot_cost(alpha: float | None, overshoot: int) -> int:
    """Extra cost for an end position ``overshoot`` chars past the text end."""
    if alpha is None or overshoot <= 0:
        return 0
    return int(np.floor(np.float32(alpha) * np.float32(overshoot)).astype(np.int64))


def overshoot_costs_vec(alpha: float | None, overshoots: np.ndarray) -> np.ndarray:
    """Vectorized ``overshoot_cost`` (int64 out)."""
    o = np.maximum(overshoots, 0)
    if alpha is None:
        return np.zeros_like(o, dtype=np.int64)
    return np.floor(np.float32(alpha) * o.astype(np.float32)).astype(np.int64)


def init_h_deltas(m: int, alpha: float | None, max_overhang: int | None) -> np.ndarray:
    """Per-row horizontal input deltas at the true text start.

    All ones without overhang; with overhang the first ``min(m, mo)`` rows get
    the 0/1 pattern ``floor((i+1)a) - floor(i*a)`` (search.rs:1692-1748).
    """
    h = np.ones(m, dtype=np.int32)
    if alpha is not None:
        mo = m if max_overhang is None else min(m, max_overhang)
        i = np.arange(mo, dtype=np.float32)
        a = np.float32(alpha)
        h[:mo] = (np.floor((i + 1) * a) - np.floor(i * a)).astype(np.int32)
    return h


def left_boundary_costs(m: int, alpha: float | None, max_overhang: int | None) -> np.ndarray:
    """Cost of the DP left boundary column for rows 0..m (inclusive)."""
    out = np.zeros(m + 1, dtype=np.int64)
    out[1:] = np.cumsum(init_h_deltas(m, alpha, max_overhang))
    return out


def find_candidates_scalar(
    total_costs: np.ndarray, k: int, all_minima: bool
) -> list[tuple[int, int]]:
    """Direct transcription of the reference's sequential end-position scan.

    ``total_costs[p]`` is the DP cost at end position ``p`` *including* any
    overshoot cost, for p in 0..=max_pos. Returns (pos, cost) pairs in
    increasing pos order.

    The scan starts with ``decreasing = True`` (search_prep, search.rs:1196)
    and reports the previous position whenever costs flip from decreasing to
    increasing (search.rs:1344-1359), plus a trailing minimum at max_pos
    (search.rs:1365-1368). ``all_minima`` instead reports every position with
    cost <= k, including position 0 (search.rs:1320-1322, 1335-1339).

    Nothing in the package calls it: it is kept as the readable
    specification of :func:`find_candidates`, which the oracle uses and
    the tests hold equal to it.
    """
    c = np.asarray(total_costs)
    P = len(c) - 1
    out: list[tuple[int, int]] = []
    if all_minima:
        for p in range(P + 1):
            if c[p] <= k:
                out.append((p, int(c[p])))
        return out

    decreasing = True
    for p in range(1, P + 1):
        if decreasing and c[p] > c[p - 1] and c[p - 1] <= k:
            out.append((p - 1, int(c[p - 1])))
        decreasing = c[p] < c[p - 1] or (decreasing and c[p] == c[p - 1])
    if decreasing and c[P] <= k:
        out.append((P, int(c[P])))
    return out


def find_candidates(
    total_costs: np.ndarray, k: int, all_minima: bool
) -> list[tuple[int, int]]:
    """Vectorized equivalent of :func:`find_candidates_scalar`."""
    c = np.asarray(total_costs, dtype=np.int64)
    P = len(c) - 1
    if all_minima:
        pos = np.nonzero(c <= k)[0]
        return [(int(p), int(c[p])) for p in pos]

    if P < 0:
        return []
    if P == 0:
        return [(0, int(c[0]))] if c[0] <= k else []

    # plateau start index for each position
    diff = np.empty(P + 1, dtype=bool)
    diff[0] = True
    diff[1:] = c[1:] != c[:-1]
    idx = np.arange(P + 1)
    ps = np.maximum.accumulate(np.where(diff, idx, 0))
    # decreasing-state after position p: plateau reaches pos 0, or the last
    # different cost before the plateau is greater.
    prev_cost = c[np.maximum(ps - 1, 0)]
    d = (ps == 0) | (prev_cost > c)

    report = np.zeros(P + 1, dtype=bool)
    report[:-1] = (c[:-1] <= k) & (c[1:] > c[:-1]) & d[:-1]
    report[P] = d[P] & (c[P] <= k)
    pos = np.nonzero(report)[0]
    return [(int(p), int(c[p])) for p in pos]
