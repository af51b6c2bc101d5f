"""CIGAR representation for alignments.

Mirrors the semantics of the reference's ``pa_types::Cigar`` as used by sassy
(see sassy src/search.rs:83-103 for the op definitions):

- ``=``: match          (consumes pattern and text)
- ``X``: substitution   (consumes pattern and text)
- ``I``: insertion      (consumes pattern only — extra char in pattern)
- ``D``: deletion       (consumes text only — extra char in text)

The CIGAR always reads in the direction of the pattern.

The port's own copy of ``sassy_tpu/cigar.py`` (the port imports nothing
of the JAX package); tests/test_torch_copies.py holds the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Op codes, kept as single characters.
MATCH = "="
SUB = "X"
INS = "I"
DEL = "D"

_OPS = (MATCH, SUB, INS, DEL)


@dataclass
class Cigar:
    """Run-length encoded list of (op, count) pairs."""

    ops: list[tuple[str, int]] = field(default_factory=list)

    def push(self, op: str) -> None:
        """Append one unit of ``op``, merging with the trailing run."""
        if self.ops and self.ops[-1][0] == op:
            prev_op, cnt = self.ops[-1]
            self.ops[-1] = (prev_op, cnt + 1)
        else:
            self.ops.append((op, 1))

    def push_n(self, op: str, n: int) -> None:
        if n <= 0:
            return
        if self.ops and self.ops[-1][0] == op:
            prev_op, cnt = self.ops[-1]
            self.ops[-1] = (prev_op, cnt + n)
        else:
            self.ops.append((op, n))

    def reverse(self) -> None:
        self.ops.reverse()

    def reversed(self) -> "Cigar":
        return Cigar(ops=list(reversed(self.ops)))

    def to_string(self) -> str:
        return "".join(f"{cnt}{op}" for op, cnt in self.ops)

    __str__ = to_string

    def __repr__(self) -> str:  # pragma: no cover - debug only
        return f"Cigar({self.to_string()!r})"

    def __bool__(self) -> bool:
        return bool(self.ops)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Cigar):
            return NotImplemented
        return self.ops == other.ops

    @staticmethod
    def from_string(s: str) -> "Cigar":
        out = Cigar()
        num = ""
        for ch in s:
            if ch.isdigit():
                num += ch
            else:
                if ch not in _OPS:
                    raise ValueError(f"invalid CIGAR op {ch!r} in {s!r}")
                out.push_n(ch, int(num) if num else 1)
                num = ""
        if num:
            raise ValueError(f"trailing count in CIGAR {s!r}")
        return out

    def expand(self) -> str:
        """One character per unit op, e.g. '2=1X' -> '==X'."""
        return "".join(op * cnt for op, cnt in self.ops)
