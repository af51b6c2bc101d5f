"""Host-side planning: shape bucketing, per-pattern DP inputs, and the
H100 tile plan.

``_bucket_words``, ``_bucket_rows``, ``suffix_rows``, ``_masks_pure_np``
and ``pattern_inputs_np`` reproduce the numpy helpers of
``sassy_tpu/ops/myers_xla.py`` (that module imports JAX, this package must
not); the tests hold them equal to the originals.
``plan_tiles`` replaces the TPU planners (``myers_xla._plan`` and
``PallasEngine._plan_layout``, which size tiles for VMEM and the (8, 128)
register layout) with a plan for one thread per tile on the H100.
"""

from __future__ import annotations

import numpy as np

from .. import semantics
from ..profiles import Profile
from .bitpack import WORD_BITS, pattern_plane_masks_np

__all__ = [
    "TAIL_RESERVE_WORDS",
    "H100_TARGET_TILES",
    "HIER_MIN_SAVED_PAIRS",
    "suffix_rows",
    "cdiv",
    "next_pow2",
    "halo_words",
    "plan_tiles",
    "pattern_inputs_np",
]

#: Packed words reserved past the text end (the overhang 'N' tail of the
#: reference engine); kept so a text's planes have the reference's shape.
TAIL_RESERVE_WORDS = 64

#: One thread scans one tile. 132 SMs x 2048 resident threads, twice over:
#: enough tiles in flight to fill the card, with a short last wave.
H100_TARGET_TILES = 2 * 132 * 2048


#: The hierarchical suffix prefilter (``suffix_rows`` > 0) runs where the
#: suffix scan saves the full scan at least this many (pattern row, window
#: word) pairs: patterns x (rows - suffix rows) x window words of the
#: single engine's tile plan or of one batched dispatch chunk. Below it the
#: saving is less than what the prefilter adds: a second launch, the flag
#: reduction and its host wait, the gather, and a scan of few tiles that
#: runs at one thread's latency. Measured on an NVIDIA H100 80GB HBM3 at
#: 700 W (chip_smoke.py, phase 15): one strand's scan and selection took
#: 10-14 ms with the prefilter against 19-20 ms without at 6.1e9 pairs
#: saved (160 bp, k=3, 1 GiB), 17-22 against 18-23 ms at 3.4e9 (8 x 72 bp,
#: k=2, 33,400 reads of 10 kbp), 10-17 against 13-14 ms at 1.7e9 (80 bp,
#: k=3, 1 GiB), and lost below 1e9.
HIER_MIN_SAVED_PAIRS = 1 << 32


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _bucket_words(x: int) -> int:
    """Round up to {4,5,6,7} * 2^k — waste <= 12.5%, few distinct shapes."""
    if x <= 16:
        return 16
    p = next_pow2(x)
    for frac in (8, 10, 12, 14):
        cand = (p // 16) * frac
        if cand >= x:
            return cand
    return p


def suffix_rows(m_min: int, k: int) -> int:
    """Rows of the hierarchical prefilter's pattern suffix; 0 = no
    prefilter. The suffix must be selective enough that few tiles flag on
    random text (s >= 8 + 6k, from 8, 16 or 32 rows), and short enough to
    save at least half the full scan's rows (m >= 2s)."""
    s = next((c for c in (8, 16, 32) if c >= 8 + 6 * k), 0)
    if s == 0 or m_min < 2 * s:
        return 0
    return s


def _bucket_rows(m: int) -> int:
    """Bucketed pattern-row count: multiples of 8 up to 128, then 64."""
    if m <= 128:
        return max(8, cdiv(m, 8) * 8)
    return cdiv(m, 64) * 64


def halo_words(m_bucket: int, k: int) -> int:
    """Left-context words a tile re-scans: an alignment spans at most m+k
    text chars (bucketed as the reference engine buckets it)."""
    h = cdiv(m_bucket + k, WORD_BITS)
    return next_pow2(h) if h <= 8 else _bucket_words(h)


def plan_tiles(words_needed: int, halo: int) -> tuple[int, int, int]:
    """(T, W, halo): T tiles of W owned words. W is at least 4 halos (the
    re-scan costs <= 25%) and grows only once the text has more than
    ``H100_TARGET_TILES`` such tiles; a text that fits one tile has no
    halo."""
    W = max(4 * halo, 16, cdiv(words_needed, H100_TARGET_TILES))
    T = cdiv(words_needed, W)
    if T == 1:
        return 1, words_needed, 0
    return T, W, halo


def _masks_pure_np(pm: np.ndarray, is_pad: np.ndarray) -> bool:
    """True when every real row's plane masks are one-hot full words (a
    plain-ACGT pattern) and pad rows are all-zero: the kernel's
    single-plane eq applies."""
    full = np.uint32(0xFFFFFFFF)
    ok = (pm == 0) | (pm == full)
    if not ok.all():
        return False
    nz = (pm != 0).sum(axis=1)
    real = is_pad == 0
    return bool((nz[real] == 1).all() and (nz[~real] == 0).all())


def pattern_inputs_np(profile: Profile, pattern_codes: np.ndarray, alpha,
                      max_overhang):
    """Per-pattern DP inputs: row-bucketed plane masks (M, P), pad-row
    flags (M,), true-start h deltas (M,), all uint32, and the left boundary
    cost at row m. Pad rows sit at the TOP, match everything and carry h
    delta 0."""
    m = len(pattern_codes)
    m_bucket = _bucket_rows(m)
    pm_real = pattern_plane_masks_np(pattern_codes, profile.planes,
                                     profile.eq_mode)
    n_pad = m_bucket - m
    pmasks = np.vstack(
        [np.zeros((n_pad, profile.planes), dtype=np.uint32), pm_real]
    )
    is_pad = np.zeros(m_bucket, dtype=np.uint32)
    is_pad[:n_pad] = 0xFFFFFFFF
    h_init = np.zeros(m_bucket, dtype=np.uint32)
    h_init[n_pad:] = semantics.init_h_deltas(m, alpha, max_overhang).astype(
        np.uint32
    )
    boundary_m = int(semantics.left_boundary_costs(m, alpha, max_overhang)[-1])
    return pmasks, is_pad, h_init, boundary_m
