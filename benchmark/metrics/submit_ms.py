"""submit_ms (ms, per layer: ``search.Searcher``, program span): the mean
over the window's calls of the program's ``submit`` span: the caller's
thread from the call's entry to its return, the patterns' encoding
(``encode``), the text set's construction (``text_set``) and each
strand's hand-off to the dispatch thread (``enqueue``). The program
records its spans into each call's ``Searcher.last_finish_split`` while
a ``torch.profiler`` runs; a span is (name, parent, thread, start ns,
end ns, thread CPU ns).

Read in a traced run on the card (a trace with device operations): on the
CPU the engines run their kernels' plain versions, whose steps are not
the card's. None where no call of the window carries spans (a program
without them)."""

SPAN = "submit"


def read(ctx):
    td = ctx.trace
    if td is None or not td.device:
        return None
    spans = [c.split["spans"] for c in ctx.calls
             if c.error is None and c.split.get("spans")]
    ms = [sum(s[4] - s[3] for s in sp if s[0] == SPAN) / 1e6 for sp in spans]
    return sum(ms) / len(ms) if ms else None
