"""Alphabet profiles: Dna, Iupac, and (case-(in)sensitive) Ascii.

Behavioral contract mirrors the reference's profile layer
(sassy src/profiles{.rs,/dna.rs,/iupac.rs,/ascii.rs}), re-designed
for the TPU engine: instead of per-64-byte-block Eq bitmask tables built on
the fly, each profile provides

- a 256-entry ``code`` table mapping text bytes to a small per-character code
  (4-bit IUPAC base-set for Dna/Iupac, folded byte for Ascii), and
- per-pattern-character *plane masks* used by the bit-parallel engines to
  compute the Eq word from pre-packed text bit-planes with a handful of
  AND/OR/XOR ops (no gathers — TPU VPU friendly).

IUPAC code bits (reference iupac.rs:281-317): A=1, C=2, T=4, G=8; ambiguity
codes are ORs; ``N``=15 matches everything; ``X``=0 matches nothing; ``U``
maps to ``T``; lookup is keyed on the low 5 bits so case is ignored.

The port's own copy of ``sassy_tpu/profiles.py`` (the port imports nothing
of the JAX package); tests/test_torch_copies.py holds the two equal.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "Profile",
    "Dna",
    "Iupac",
    "Ascii",
    "CaseSensitiveAscii",
    "CaseInsensitiveAscii",
    "get_profile",
]

# ---------------------------------------------------------------------------
# IUPAC tables


def _build_iupac_code32() -> np.ndarray:
    """IUPAC_CODE keyed by (byte & 0x1F); 255 = invalid slot.

    Mirrors reference iupac.rs:281-317 (bit order A=1, C=2, T=4, G=8).
    """
    t = np.full(32, 255, dtype=np.uint8)
    A, C, T, G = 1, 2, 4, 8
    codes = {
        "A": A, "C": C, "T": T, "U": T, "G": G,
        "N": A | C | T | G,
        "R": A | G, "Y": C | T, "S": G | C, "W": A | T,
        "K": G | T, "M": A | C,
        "B": C | G | T, "D": A | G | T, "H": A | C | T, "V": A | C | G,
        "X": 0,
    }
    for ch, code in codes.items():
        t[ord(ch) & 0x1F] = code
    return t


_IUPAC_CODE32 = _build_iupac_code32()

#: 256-entry engine code table: 4-bit base set per byte. Invalid slots get
#: their low nibble (255 & 0xF == 15), matching the reference's packed-nibble
#: hot path (iupac.rs:319-330) which also reduces invalid codes to 15.
_IUPAC_CODE256 = (_IUPAC_CODE32[np.arange(256) & 0x1F] & 0x0F).astype(np.uint8)

#: Full (unreduced) code for validity checks: 255 = not an IUPAC char slot.
_IUPAC_FULL256 = _IUPAC_CODE32[np.arange(256) & 0x1F]


def _build_iupac_rc() -> np.ndarray:
    """Reference iupac.rs RC table (identity for unknown bytes)."""
    rc = np.arange(256, dtype=np.uint8)
    pairs = {
        "A": "T", "C": "G", "T": "A", "G": "C",
        "R": "Y", "Y": "R", "S": "S", "W": "W", "K": "M", "M": "K",
        "B": "V", "D": "H", "H": "D", "V": "B", "N": "N", "X": "X",
    }
    for a, b in pairs.items():
        rc[ord(a)] = ord(b)
        rc[ord(a.lower())] = ord(b.lower())
    return rc


_IUPAC_RC = _build_iupac_rc()


def _build_dna_rc() -> np.ndarray:
    """Reference dna.rs RC table: only uppercase ACGT mapped (a quirk we keep:
    lowercase bytes are left unchanged, dna.rs:121-133)."""
    rc = np.arange(256, dtype=np.uint8)
    for a, b in {"A": "T", "C": "G", "T": "A", "G": "C"}.items():
        rc[ord(a)] = ord(b)
    return rc


_DNA_RC = _build_dna_rc()

#: DNA engine code table. The reference encodes pattern chars as
#: ``(c >> 1) & 3`` (A=0, C=1, T=2, G=3; dna.rs:21) — every byte maps to one
#: of the four bases (garbage-in-garbage-out for non-ACGT, as in the
#: reference). We translate that 2-bit index to the IUPAC one-hot nibble so
#: both DNA and IUPAC share one engine.
_DNA_CODE256 = np.array([1, 2, 4, 8], dtype=np.uint8)[(np.arange(256) >> 1) & 3]


def _plane_masks(entries: np.ndarray, planes: int) -> tuple:
    """Per-plane 32-bit truth tables from a <=32-entry code table."""
    out = []
    for p in range(planes):
        mask = 0
        for i, code in enumerate(entries[:32]):
            mask |= ((int(code) >> p) & 1) << i
        out.append(mask)
    return tuple(out)


_IUPAC_PLANE_MASKS = _plane_masks(_IUPAC_CODE32 & 0x0F, 4)
_DNA_PLANE_MASKS = _plane_masks(np.array([1, 2, 4, 8], np.uint8), 4)

_ASCII_LOWER = np.arange(256, dtype=np.uint8)
_lower_mask = (_ASCII_LOWER >= ord("A")) & (_ASCII_LOWER <= ord("Z"))
_ASCII_LOWER = np.where(_lower_mask, _ASCII_LOWER + 32, _ASCII_LOWER).astype(np.uint8)


def as_bytes_array(seq) -> np.ndarray:
    """Coerce bytes/str/ndarray to a uint8 numpy array."""
    if isinstance(seq, np.ndarray):
        return seq.astype(np.uint8, copy=False)
    if isinstance(seq, str):
        seq = seq.encode()
    return np.frombuffer(bytes(seq), dtype=np.uint8)


# ---------------------------------------------------------------------------


class Profile:
    """Base alphabet profile.

    Attributes:
        name: profile name used by CLI/bindings ("dna", "iupac", "ascii").
        planes: number of text bit-planes the engine packs (4 or 8).
        eq_mode: "iupac" (Eq = OR of planes selected by the pattern nibble)
            or "ascii" (Eq = NOT OR of plane XOR pattern-bit).
        code_table: (256,) uint8 mapping text bytes to engine codes.
    """

    name: str = ""
    planes: int = 4
    eq_mode: str = "iupac"
    supports_overhang: bool = False
    code_table: np.ndarray

    #: Gather-free device packing descriptor. "table5": engine code bit p of
    #: byte b = bit ((b >> pack_shift) & pack_mask) of pack_plane_masks[p]
    #: (a <=32-entry truth table evaluated with a vectorized variable shift —
    #: no gather, which runs ~30M elem/s on TPU). "byte": code bits are the
    #: (case-folded) byte's own bits.
    pack_mode: str = "table5"
    pack_shift: int = 0
    pack_mask: int = 31
    pack_plane_masks: tuple = ()
    pack_fold_case: bool = False

    # --- encoding -----------------------------------------------------
    def encode(self, seq) -> np.ndarray:
        """Map a byte sequence to engine codes (uint8)."""
        return self.code_table[as_bytes_array(seq)]

    def pattern_codes(self, pattern) -> np.ndarray:
        """Engine codes for the pattern (same table unless overridden)."""
        return self.encode(pattern)

    # --- semantics ----------------------------------------------------
    def is_match(self, c1: int, c2: int) -> bool:
        raise NotImplementedError

    def is_match_slice(self, pattern, text) -> bool:
        p = as_bytes_array(pattern)
        t = as_bytes_array(text)
        if len(p) != len(t):
            return False
        return all(self.is_match(int(a), int(b)) for a, b in zip(p, t))

    def match_mask(self, pattern_codes: np.ndarray, text_codes: np.ndarray) -> np.ndarray:
        """(m, n) bool array of per-character matches on engine codes."""
        raise NotImplementedError

    def valid_seq(self, seq) -> bool:
        raise NotImplementedError

    def complement(self, seq) -> bytes:
        raise NotImplementedError

    def reverse_complement(self, seq) -> bytes:
        return bytes(as_bytes_array(self.complement(seq))[::-1])

    def count_n(self, seq) -> int:
        """Number of literal 'N'/'n' bytes (n-filter counts bytes, not codes;
        reference n_filter.rs:26-29)."""
        b = as_bytes_array(seq)
        return int(np.count_nonzero((b == ord("N")) | (b == ord("n"))))


class Iupac(Profile):
    """IUPAC nucleotide profile (reference iupac.rs). Supports overhang."""

    name = "iupac"
    planes = 4
    eq_mode = "iupac"
    supports_overhang = True
    code_table = _IUPAC_CODE256
    pack_mode = "table5"
    pack_shift = 0
    pack_mask = 31
    pack_plane_masks = _IUPAC_PLANE_MASKS

    #: Engine pad code for text beyond the end: 'X'-like (matches nothing).
    pad_code = 0
    #: Pad code when overhang is enabled: 'N'-like (matches everything), so
    #: diagonal costs continue past the text end (reference search.rs:203).
    overhang_pad_code = 15

    def is_match(self, c1: int, c2: int) -> bool:
        return (int(_IUPAC_CODE256[c1]) & int(_IUPAC_CODE256[c2])) > 0

    def match_mask(self, pattern_codes, text_codes):
        return (pattern_codes[:, None] & text_codes[None, :]) > 0

    def valid_seq(self, seq) -> bool:
        b = as_bytes_array(seq)
        up = b & np.uint8(~0x20 & 0xFF)
        in_range = (up > ord("@")) & (up < ord("Z"))
        return bool(np.all(in_range & (_IUPAC_FULL256[b] != 255)))

    def complement(self, seq) -> bytes:
        return bytes(_IUPAC_RC[as_bytes_array(seq)])


class Dna(Profile):
    """Plain ACGT profile (reference dna.rs). No overhang support; non-ACGT
    input gives garbage (every byte maps to one of the four bases)."""

    name = "dna"
    planes = 4
    eq_mode = "iupac"
    supports_overhang = False
    code_table = _DNA_CODE256
    pad_code = 0
    overhang_pad_code = 0
    pack_mode = "table5"
    pack_shift = 1
    pack_mask = 3
    pack_plane_masks = _DNA_PLANE_MASKS

    def is_match(self, c1: int, c2: int) -> bool:
        # Case-insensitive byte equality (dna.rs:48-50).
        return (c1 | 0x20) == (c2 | 0x20)

    def match_mask(self, pattern_codes, text_codes):
        return (pattern_codes[:, None] & text_codes[None, :]) > 0

    def valid_seq(self, seq) -> bool:
        low = as_bytes_array(seq) | np.uint8(0x20)
        return bool(
            np.all(
                (low == ord("a")) | (low == ord("c")) | (low == ord("g")) | (low == ord("t"))
            )
        )

    def complement(self, seq) -> bytes:
        return bytes(_DNA_RC[as_bytes_array(seq)])


class Ascii(Profile):
    """ASCII profile (reference ascii.rs). ``case_sensitive`` selects exact or
    case-folded byte equality. No reverse complement, no overhang."""

    name = "ascii"
    planes = 8
    eq_mode = "ascii"
    supports_overhang = False
    pad_code = 0  # NUL: never equal to itself via the engine (see eq note)

    pack_mode = "byte"

    def __init__(self, case_sensitive: bool = True):
        self.case_sensitive = case_sensitive
        self.pack_fold_case = not case_sensitive
        self.code_table = (
            np.arange(256, dtype=np.uint8) if case_sensitive else _ASCII_LOWER
        )

    #: In ascii eq_mode the engine compares folded bytes for equality; padding
    #: must never match any pattern char. The engines reserve a dedicated
    #: "pad plane" for this (see ops/), since byte 0 is a legal ASCII char.
    overhang_pad_code = 0

    def is_match(self, c1: int, c2: int) -> bool:
        if self.case_sensitive:
            return c1 == c2
        return int(_ASCII_LOWER[c1]) == int(_ASCII_LOWER[c2])

    def match_mask(self, pattern_codes, text_codes):
        return pattern_codes[:, None] == text_codes[None, :]

    def valid_seq(self, seq) -> bool:
        return True

    def complement(self, seq) -> bytes:
        raise NotImplementedError("Ascii profile has no complement")


def CaseSensitiveAscii() -> Ascii:
    return Ascii(case_sensitive=True)


def CaseInsensitiveAscii() -> Ascii:
    return Ascii(case_sensitive=False)


def get_profile(name: str) -> Profile:
    """Profile by name, as used by CLI and bindings (reference python.rs:27-63)."""
    name = name.lower()
    if name == "dna":
        return Dna()
    if name == "iupac":
        return Iupac()
    if name == "ascii":
        return Ascii(case_sensitive=True)
    if name in ("ascii-insensitive", "ascii_insensitive"):
        return Ascii(case_sensitive=False)
    raise ValueError(f"unknown profile {name!r} (expected dna/iupac/ascii)")
