"""N-fraction filtering (reference sassy src/n_filter.rs).

Matches over long ``NNN...`` stretches are usually meaningless (N matches
everything in IUPAC); these filters drop them. N's are counted as literal
'N'/'n' *bytes* regardless of profile.

The port's own copy of ``sassy_tpu/nfilter.py`` (the port imports nothing
of the JAX package); tests/test_torch_copies.py holds the two equal.
"""

from __future__ import annotations

import numpy as np

from .matchrec import Match
from .profiles import as_bytes_array

__all__ = ["check_n_fraction", "satisfy_n_endpoint_filter", "traced_satisfy_n_frac"]


def _count_n(text: np.ndarray, start: int, end: int) -> int:
    sl = text[start:end]
    return int(np.count_nonzero((sl == ord("N")) | (sl == ord("n"))))


def check_n_fraction(
    text: np.ndarray,
    start_pos: int,
    end_pos: int,
    max_n_frac: float,
    denominator: int | None = None,
) -> bool:
    """True iff text[start:end] has N-fraction <= max_n_frac
    (n_filter.rs:8-34). Positions beyond the text are not counted."""
    if start_pos >= len(text):
        return True
    end_pos = min(end_pos, len(text))
    length = end_pos - start_pos
    if length <= 0:
        return True
    n_count = _count_n(text, start_pos, end_pos)
    denom = denominator if denominator is not None else length
    return np.float32(n_count) / np.float32(denom) <= np.float32(max_n_frac)


def satisfy_n_endpoint_filter(
    end_pos: int, text: np.ndarray, pattern_len: int, k: int, max_n_frac: float
) -> bool:
    """Conservative pre-trace filter on the mandatory window
    ``text[end-(m-k) : end]`` with denominator ``m+k`` (n_filter.rs:41-52):
    never drops a match the exact filter would keep."""
    end_pos = min(end_pos, len(text))
    mandatory_len = max(0, pattern_len - k)
    start_pos = max(0, end_pos - mandatory_len)
    return check_n_fraction(text, start_pos, end_pos, max_n_frac, pattern_len + k)


def traced_satisfy_n_frac(m: Match, text, max_n_frac: float) -> bool:
    """Exact post-trace filter over the matched region (n_filter.rs:58-60)."""
    t = as_bytes_array(text)
    return check_n_fraction(t, m.text_start, m.text_end, max_n_frac)
