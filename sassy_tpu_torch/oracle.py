"""Pure-NumPy semantics oracle: the executable specification of the search.

Computes the semi-global edit-distance DP directly (O(n*m), vectorized per
row). The traceback re-fills each candidate's window with it.

DP definition (matching the reference's bit-parallel formulation,
sassy src/bitpacking.rs + trace.rs:17-54):

    D[0, i] = 0                      (match may start anywhere in the text)
    D[j, 0] = boundary(j)            (j, or the overhang-discounted cost)
    D[j, i] = min(D[j-1, i-1] + (0 if pattern[j-1] ~ text[i-1] else 1),
                  D[j-1, i]   + 1,   # insertion: extra pattern char
                  D[j,   i-1] + 1)   # deletion: extra text char

``D[m, p]`` is the best cost of an alignment of the full pattern ending at
text position ``p``.

The port's own copy of ``sassy_tpu/oracle.py`` (the port imports nothing
of the JAX package); tests/test_torch_copies.py holds the two equal.
"""

from __future__ import annotations

import numpy as np

from .profiles import Profile
from .semantics import left_boundary_costs

__all__ = ["dp_matrix"]


def dp_matrix(
    profile: Profile,
    pattern_codes: np.ndarray,
    text_codes: np.ndarray,
    alpha: float | None,
    max_overhang: int | None,
) -> np.ndarray:
    """Full (m+1, n+1) cost matrix over *engine codes*.

    Rows are vectorized with the prefix-min trick: the deletion recurrence
    ``D[j,i] = min_{i'<=i}(base[i'] + (i-i'))`` is a cumulative min of
    ``base - i``.
    """
    m = len(pattern_codes)
    n = len(text_codes)
    boundary = left_boundary_costs(m, alpha, max_overhang)
    mm = profile.match_mask(pattern_codes, text_codes)  # (m, n) bool

    D = np.zeros((m + 1, n + 1), dtype=np.int64)
    D[:, 0] = boundary
    idx = np.arange(n + 1, dtype=np.int64)
    for j in range(1, m + 1):
        prev = D[j - 1]
        base = np.empty(n + 1, dtype=np.int64)
        base[0] = boundary[j]
        base[1:] = np.minimum(prev[:-1] + (1 - mm[j - 1]), prev[1:] + 1)
        D[j] = np.minimum.accumulate(base - idx) + idx
    return D
