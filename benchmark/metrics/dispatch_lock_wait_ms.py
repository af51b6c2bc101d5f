"""dispatch_lock_wait_ms (ms, per layer: the text set's dispatch thread,
``ops/batch.py`` ``BatchEngine.candidates_many_async``, program spans):
the mean over the window's calls of the time the dispatch thread spent
off its CPU in the call's ``dispatch`` spans, other than in the waits the
program names: for each ``dispatch`` span its wall time less its thread's
CPU time, less the same of each ``device_wait`` (a host read, or a copy
from pageable memory, which PyTorch synchronises with the stream: the
piece plan's and the pattern groups' uploads, the text set's tables),
``stage_wait`` (a staging buffer's last copy) and ``stage_fill`` (the
host fill, whose helper threads copy while the dispatch thread waits)
inside it. The rest is mostly the wait for the interpreter lock, while
the caller's thread holds it (the submit of the next call, the finish and
Match build of the last); it also holds any block the program does not
name: a launch held back by a full launch queue, a device allocation. A
blocking call lets the lock go and takes it back before it returns: a
wait for the lock that such a return adds counts with the named wait it
ends, not here.

A span's CPU time is as fine as the platform's thread CPU clock
(``time.thread_time_ns``). Where a kernel advances that clock in
scheduler ticks (10 ms on some hosts), each span's CPU time is a count of
ticks, off by up to one tick, and a call subtracts a hundred-odd named
waits: the mean is then resolved to no better than tens of ms and can
read below 0 where the true wait is near 0.

Read in a traced run on the card (a trace with device operations), from
the spans the program records into each call's
``Searcher.last_finish_split`` while a ``torch.profiler`` runs; None where
no call of the window carries a ``dispatch`` span."""

SPAN = "dispatch"
#: the named waits taken out of the dispatch spans' time off the CPU
WAITS = ("device_wait", "stage_wait", "stage_fill")


def _off_cpu_ns(s) -> int:
    return (s[4] - s[3]) - s[5]


def call_ns(spans):
    """(off-CPU ns of the call's dispatch spans less their named waits,
    whether it had a dispatch span)."""
    total, seen = 0, False
    for i, s in enumerate(spans):
        if s[0] == SPAN:
            total += _off_cpu_ns(s)
            seen = True
        elif s[0] in WAITS:
            # the outermost named wait under a dispatch span
            p = s[1]
            while p >= 0 and spans[p][0] not in WAITS + (SPAN,):
                p = spans[p][1]
            if p >= 0 and spans[p][0] == SPAN:
                total -= _off_cpu_ns(s)
    return total, seen


def read(ctx):
    td = ctx.trace
    if td is None or not td.device:
        return None
    per_call = []
    for c in ctx.calls:
        if c.error is None and c.split.get("spans"):
            ns, seen = call_ns(c.split["spans"])
            if seen:
                per_call.append(ns / 1e6)
    return sum(per_call) / len(per_call) if per_call else None
