"""idle_in_dispatch_pct (%, per layer: the device, program spans and the
device trace): the share of the traced window in which the card is idle
(no kernel, copy or memset: ``trace.gaps``) while the dispatch thread is
in one of the program's ``dispatch`` spans, the device work of a call
being enqueued. It is at most ``device_idle_pct``; what that metric has
beyond it is idle time while the dispatch thread has no job: the caller's
thread paces the card then.

The ``dispatch`` spans are those the program records into each call's
``Searcher.last_finish_split`` while a ``torch.profiler`` runs, on the
profiler's clock (Unix-epoch ns), the clock of the device trace. None
without a trace with device operations or without a ``dispatch`` span."""

from benchmark.trace import gaps

SPAN = "dispatch"


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(ctx):
    td = ctx.trace
    if td is None or not td.device or td.end <= td.start:
        return None
    busy = _merged((s[3], s[4]) for c in ctx.calls
                   if c.error is None and c.split.get("spans")
                   for s in c.split["spans"] if s[0] == SPAN)
    if not busy:
        return None
    both, i = 0, 0
    for gs, ge in gaps(td):  # disjoint and in order, as are the spans
        while i < len(busy) and busy[i][1] <= gs:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < ge:
            both += min(ge, busy[j][1]) - max(gs, busy[j][0])
            j += 1
    return 100.0 * both / (td.end - td.start)
