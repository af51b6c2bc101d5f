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
of the JAX package); tests/test_torch_copies.py holds the two equal.
Only the overhang math is copied: the port selects candidates on the
device (``ops/minima.py``).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "overhang_steps",
    "overshoot_cost",
    "left_boundary_costs",
    "overshoot_costs_vec",
    "init_h_deltas",
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
