"""Pattern plane masks for the bit-parallel scan.

The text is P bit-planes of packed 32-bit words (``myers_torch.pack``):
bit ``32*w + i`` of plane ``p`` is bit ``p`` of the engine code of text char
``32*w + i``. A pattern row's Eq word is the OR of the planes its code
selects (iupac) or the byte equality of the planes (ascii).

The port's own copy of the two names of ``sassy_tpu/ops/bitpack.py`` that it
uses; tests/test_torch_copies.py holds them equal.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pattern_plane_masks_np", "WORD_BITS"]

WORD_BITS = 32


def pattern_plane_masks_np(
    pattern_codes: np.ndarray, planes: int, eq_mode: str
) -> np.ndarray:
    """(m, planes) uint32 per-row masks.

    iupac mode: mask[j, p] = all-ones iff bit p set in pattern code j.
    ascii mode: mask[j, p] = all-ones iff bit p set (XOR-compare splat).
    """
    m = len(pattern_codes)
    out = np.zeros((m, planes), dtype=np.uint32)
    for p in range(planes):
        bit = (pattern_codes.astype(np.uint32) >> p) & 1
        out[:, p] = np.where(bit == 1, np.uint32(0xFFFFFFFF), np.uint32(0))
    del eq_mode  # same representation for both modes
    return out
