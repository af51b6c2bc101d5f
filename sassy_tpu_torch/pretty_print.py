"""Colourized alignment rendering for the CLI.

The port's own copy of ``sassy_tpu/pretty_print.py``
(tests/test_torch_surfaces.py holds the two equal), a behavioural port of
the reference's pretty printer (sassy src/pretty_print.rs): green =
match, yellow = substitution (text char), cyan = deletion (extra text
char), red = insertion (pattern char missing from text; un-bolded when it
is an overhang), with
``Full`` / ``Compact`` / ``Line`` styles, pattern/text display direction for
RC matches, and "+N bp" context-skip markers.
"""

from __future__ import annotations

import numpy as np

from .cigar import DEL, INS, MATCH, SUB, Cigar
from .matchrec import Match, Strand
from .profiles import Iupac, as_bytes_array

__all__ = [
    "PrettyPrintDirection",
    "PrettyPrintStyle",
    "pretty_print_match",
    "pretty_print",
]

_IUPAC = Iupac()


class PrettyPrintDirection:
    PATTERN = "pattern"  # print RC matches in pattern direction
    TEXT = "text"  # print matches as they appear in the input text


class PrettyPrintStyle:
    COMPACT = "compact"
    FULL = "full"
    LINE = "line"


# ANSI styling (the reference forces colours on; honour that for parity,
# callers can strip with color=False)
def _c(s: str, code: str, color: bool) -> str:
    if not color:
        return s
    return f"\x1b[{code}m{s}\x1b[0m"


def _green(s, color):
    return _c(s, "32", color)


def _yellow_bold(s, color):
    return _c(s, "1;33", color)


def _cyan_bold(s, color):
    return _c(s, "1;36", color)


def _red(s, color, bold):
    return _c(s, "1;31" if bold else "31", color)


def _bold(s, color):
    return _c(s, "1", color)


def _dim(s, color):
    return _c(s, "2", color)


def pretty_print_match(pattern, text, cigar: Cigar, color: bool = True):
    """Render the matching text region; returns (display_len, string).

    ``text`` is the matching slice (text[text_start:text_end]); ``pattern``
    the full pattern. Overhang is expected as flanking Ins ops (the caller
    inserts them, mirroring pretty_print.rs:120-132).
    """
    ops = cigar.expand()  # list of op chars, one per step
    if not ops:
        return 0, ""
    pattern = as_bytes_array(pattern)
    text = as_bytes_array(text)
    prefix_ins = 0
    for op in ops:
        if op == INS:
            prefix_ins += 1
        else:
            break
    suffix_ins = 0
    for op in reversed(ops):
        if op == INS:
            suffix_ins += 1
        else:
            break

    out = []
    i = 0  # text pos
    j = 0  # pattern pos
    for idx, op in enumerate(ops):
        if op == MATCH:
            out.append(_green(chr(text[i]), color))
            i += 1
            j += 1
        elif op == SUB:
            out.append(_yellow_bold(chr(text[i]), color))
            i += 1
            j += 1
        elif op == DEL:  # extra text char
            out.append(_cyan_bold(chr(text[i]), color))
            i += 1
        else:  # INS: pattern char absent from text
            is_overhang = idx < prefix_ins or idx >= len(ops) - suffix_ins
            out.append(_red(chr(pattern[j]), color, not is_overhang))
            j += 1
    return len(ops), "".join(out)


def _format_skip(skip: int, prefix: bool) -> str:
    if skip > 0:
        return f"{skip:>9} bp + " if prefix else f" + {skip:>9} bp"
    return f" {'':>9}     "


def pretty_print(
    m: Match,
    pattern_id: str | None,
    pattern,
    text,
    direction: str = PrettyPrintDirection.TEXT,
    context: int = 20,
    style: str = PrettyPrintStyle.FULL,
    color: bool = True,
) -> str:
    """Render one match with context (pretty_print.rs:83-227)."""
    pattern = as_bytes_array(pattern)
    text = as_bytes_array(text)
    text_start, text_end = m.text_start, m.text_end
    pattern_start, pattern_end = m.pattern_start, m.pattern_end
    cigar = Cigar(list(m.cigar.ops))

    if m.strand is Strand.RC:
        if direction == PrettyPrintDirection.PATTERN:
            text = as_bytes_array(_IUPAC.reverse_complement(text))
            text_start, text_end = len(text) - m.text_end, len(text) - m.text_start
        else:
            pattern = as_bytes_array(_IUPAC.reverse_complement(pattern))
            pattern_start, pattern_end = (
                len(pattern) - m.pattern_end,
                len(pattern) - m.pattern_start,
            )
            cigar.reverse()

    # overhang shown as flanking insertions
    if pattern_start > 0:
        cigar.ops.insert(0, (INS, pattern_start))
    if pattern_end < len(pattern):
        cigar.ops.append((INS, len(pattern) - pattern_end))

    prefix = text[:text_start]
    matching_text = text[text_start:text_end]
    suffix = text[text_end:]

    prefix_skip = 0
    if len(prefix) > context:
        prefix_skip = len(prefix) - context
        prefix = prefix[prefix_skip:]
    prefix_skip_s = _format_skip(prefix_skip, True)

    match_len, match_string = pretty_print_match(pattern, matching_text, cigar, color)

    suffix_skip = len(suffix) + match_len - len(pattern) - context
    if suffix_skip > 0:
        suffix = suffix[: max(0, len(suffix) - suffix_skip)]
    suffix_padding = max(0, -suffix_skip)
    suffix_skip_s = _format_skip(max(0, suffix_skip), False)

    strand = "+" if m.strand is Strand.FWD else "-"
    prefix_s = prefix.tobytes().decode(errors="replace")
    suffix_s = suffix.tobytes().decode(errors="replace")

    if style == PrettyPrintStyle.FULL:
        return (
            f"{pattern_id or ''} ({_bold(strand, color)}) {_bold(f'{m.cost:>2}', color)}"
            f" | {_dim(prefix_skip_s, color)}{prefix_s:>{context}}{match_string}"
            f"{suffix_s}{'':>{suffix_padding}}{_dim(suffix_skip_s, color)}"
            f" @ {_dim(f'{text_start}-{text_end}'.ljust(19), color)}"
        )
    if style == PrettyPrintStyle.COMPACT:
        return (
            f"{_bold(strand, color)} {_bold(f'{m.cost:>2}', color)}"
            f" | {prefix_s:>{context}}{match_string}{suffix_s}"
        )
    # LINE style: bound the context to the current line
    MAX_PADDING = 50
    line_start = text_start
    while (
        line_start > 0
        and text_start - line_start < MAX_PADDING
        and text[line_start - 1] != 0x0A
    ):
        line_start -= 1
    line_end = text_end
    while (
        line_end < len(text) - 1
        and line_end - text_end < MAX_PADDING
        and text[line_end + 1] != 0x0A
    ):
        line_end += 1
    line_prefix = text[line_start:text_start].tobytes().decode(errors="replace")
    line_suffix = text[text_end:line_end].tobytes().decode(errors="replace")
    width = int(np.floor(np.log10(max(1, len(text))))) + 1
    return (
        f"{_dim(str(text_start).ljust(width), color)}: "
        f"{_bold(f'{m.cost:>2}', color)} | {line_prefix}{match_string}{line_suffix}"
    )
