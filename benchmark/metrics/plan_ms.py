"""plan_ms (ms, per layer: the text set, ``ops/batch.py``
``TextSet.piece_plan``, program span): the mean over the window's calls of
their summed ``plan`` spans: the piece plan of the call's text set (the
texts cut into pieces, their columns uploaded), on the dispatch thread. A
call whose text set had its plan already records none and adds 0.

Read in a traced run on the card (a trace with device operations), from
the spans the program records into each call's
``Searcher.last_finish_split`` while a ``torch.profiler`` runs; None where
no call of the window carries spans."""

SPAN = "plan"


def read(ctx):
    td = ctx.trace
    if td is None or not td.device:
        return None
    spans = [c.split["spans"] for c in ctx.calls
             if c.error is None and c.split.get("spans")]
    ms = [sum(s[4] - s[3] for s in sp if s[0] == SPAN) / 1e6 for sp in spans]
    return sum(ms) / len(ms) if ms else None
