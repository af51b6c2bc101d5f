"""Match record and Strand, mirroring the reference's output schema.

Reference: sassy src/search.rs:32-119 (``Match``/``Strand``).

All indices are 0-based; ``text_end``/``pattern_end`` are exclusive. For
reverse-complement matches (``strand == Strand.RC``) the coordinates index the
*forward* text as given by the user, and the pattern matches
``rc(text[text_start:text_end])``. The CIGAR always reads in the direction of
the pattern.

``without_trace`` searches use ``UNKNOWN`` (== usize::MAX in the reference,
search.rs:1421-1431, 869-871) for coordinates that were not computed.

The port's own copy of ``sassy_tpu/matchrec.py`` (the port imports nothing
of the JAX package); tests/test_torch_copies.py holds the two equal.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from .cigar import DEL, INS, MATCH, SUB, Cigar

#: Sentinel for coordinates not computed in `without_trace` mode
#: (reference uses usize::MAX).
UNKNOWN = 2**64 - 1


class Strand(enum.IntEnum):
    """Strand of a match (reference search.rs:114-119). FWD sorts before RC."""

    FWD = 0
    RC = 1

    def __str__(self) -> str:
        return "+" if self is Strand.FWD else "-"


@dataclass
class Match:
    """A match of the pattern against the text (reference search.rs:32-112)."""

    pattern_idx: int = 0
    text_idx: int = 0
    text_start: int = 0
    text_end: int = 0
    pattern_start: int = 0
    pattern_end: int = 0
    cost: int = 0
    strand: Strand = Strand.FWD
    cigar: Cigar = field(default_factory=Cigar)

    def sort_key(self):
        """Ordering key. The reference derives Ord over fields in declaration
        order with the cigar ignored (search.rs:59-61)."""
        return (
            self.pattern_idx,
            self.text_idx,
            self.text_start,
            self.text_end,
            self.pattern_start,
            self.pattern_end,
            self.cost,
            int(self.strand),
        )

    def __lt__(self, other: "Match") -> bool:
        return self.sort_key() < other.sort_key()

    def same_as(self, other: "Match") -> bool:
        """Full equality including the CIGAR string (for conformance tests)."""
        return self.sort_key() == other.sort_key() and self.cigar == other.cigar

    def to_path(self) -> list[tuple[int, int]]:
        """(pattern_pos, text_pos) walk of the alignment
        (reference search.rs:83-103)."""
        if self.strand is Strand.RC:
            text_pos, sign = self.text_end - 1, -1
        else:
            text_pos, sign = self.text_start, 1
        pos = (self.pattern_start, text_pos)
        path = [pos]
        for op, cnt in self.cigar.ops:
            for _ in range(cnt):
                dp, dt = {
                    MATCH: (1, sign),
                    SUB: (1, sign),
                    INS: (1, 0),
                    DEL: (0, sign),
                }[op]
                pos = (pos[0] + dp, pos[1] + dt)
                path.append(pos)
        path.pop()
        return path

    def without_cigar(self) -> "Match":
        return Match(
            pattern_idx=self.pattern_idx,
            text_idx=self.text_idx,
            text_start=self.text_start,
            text_end=self.text_end,
            pattern_start=self.pattern_start,
            pattern_end=self.pattern_end,
            cost=self.cost,
            strand=self.strand,
        )

    def __repr__(self) -> str:
        return (
            f"Match(pattern_idx={self.pattern_idx}, text_idx={self.text_idx}, "
            f"text_start={self.text_start}, text_end={self.text_end}, "
            f"pattern_start={self.pattern_start}, pattern_end={self.pattern_end}, "
            f"cost={self.cost}, strand={self.strand.name}, "
            f"cigar={self.cigar.to_string()!r})"
        )
