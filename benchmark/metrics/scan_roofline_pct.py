"""scan_roofline_pct (%, per layer: the kernels, ``ops/myers_cuda.py`` and
``csrc/``): the least time the window's scan work could take on the card,
over the summed device time of the scan kernels in the traced window.

The work is counted from the algorithm, not from the program's kernels, so
that a faster kernel moves the share and not the yardstick. For each call:
Q patterns x m rows (each pattern's real length) x ceil(text bases / 32)
words x 2 strands, each (row, word) one step of Myers' bit-vector
algorithm (Myers 1999, doi:10.1145/316542.316550, with Hyyro's horizontal
form of the step), at ``OPS_PER_STEP`` operations. The bytes are the text
read once, at ``TEXT_BITS_PER_BASE`` a base and a strand, and the matches
written once, ``MATCH_BYTES`` each. The least time is the larger of the
operations over ``PEAK_INT32_OPS_S`` and the bytes over ``PEAK_BYTES_S``;
the operations bound it at these shapes by three orders of magnitude.

``OPS_PER_STEP``: the step over one word of a row, with the word's match
mask Eq, the row's vertical deltas (Pv, Mv) and the carries in, counted so
that no implementation on sm_90 can do it in fewer: a three-input logic
operation (LOP3) is one, a shift that takes in a carry (a funnel shift, or
an add of the value to itself) is one, and the match mask, the carries
out, the score, loads and stores are not counted at all.

    1  X   = Eq | Mv
    2  T   = Eq & Pv
    3  S   = T + Pv                  (an add: no logic operation carries)
    4  Xh  = (S ^ Pv) | Eq           (one LOP3)
    5  Ph  = Mv | ~(Xh | Pv)         (one LOP3)
    6  Mh  = Pv & Xh
    7  Ph' = (Ph << 1) | carry
    8  Mh' = (Mh << 1) | carry
    9  Pv  = Mh' | ~(X | Ph')        (one LOP3)
    10 Mv  = Ph' & X

Steps 2 and 3 cannot merge (no instruction both masks and adds); 4-6 make
two values from four inputs, which takes three LOP3 however they are cut;
7 and 8 are two shifts; 1, 9 and 10 make two values from four inputs,
three operations again. So 10.

``PEAK_INT32_OPS_S``: 132 SMs x 64 INT32 lanes x 1.98 GHz (NVIDIA H100 SXM5
data sheet and the Hopper tuning guide: 64 INT32 results a clock an SM, a
boost clock of 1,980 MHz) = 1.6727e13 a second. ``PEAK_BYTES_S``: 3.35 TB/s
of HBM3 (the same data sheet). Both are constants, never read from the
running card.
"""

from benchmark.trace import short_name

OPS_PER_STEP = 10
WORD_BITS = 32
TEXT_BITS_PER_BASE = 2
MATCH_BYTES = 8
PEAK_INT32_OPS_S = 132 * 64 * 1.98e9
PEAK_BYTES_S = 3.35e12
#: the scan kernels whose device time is the denominator
SCAN_KERNELS = ("scan_q_meta_kernel", "scan_q_kernel")


def least_seconds(pattern_lengths, bases: int, strands: int,
                  matches: int) -> tuple:
    """(least seconds, "ops" or "bytes") of one call's scan work."""
    words = -(-bases // WORD_BITS)
    ops = sum(pattern_lengths) * words * strands * OPS_PER_STEP
    nbytes = (strands * -(-bases * TEXT_BITS_PER_BASE // 8)
              + matches * MATCH_BYTES)
    t_ops, t_bytes = ops / PEAK_INT32_OPS_S, nbytes / PEAK_BYTES_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def read(ctx):
    td = ctx.trace
    if td is None:
        return None
    scan_ns = sum(max(0, min(e, td.end) - max(s, td.start))
                  for name, kind, s, e in td.device
                  if kind == "kernel" and short_name(name) in SCAN_KERNELS)
    if scan_ns <= 0:
        return None
    least = sum(least_seconds(ctx.pattern_lengths, c.bases, ctx.strands,
                              max(c.matches, 0))[0]
                for c in ctx.calls if c.error is None)
    return 100.0 * least / (scan_ns / 1e9)
