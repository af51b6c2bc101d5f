"""stage_fill_gb_s (GB/s, per layer: the text set, ``ops/myers_torch.py``
``_stage_chunks``, ``csrc/stage_fill.cc``, program span and counter): the
bytes of the texts copied into the pinned staging buffers over the
seconds of those copies, over the window's calls: the sum of the calls'
``fill_bytes`` counters over the sum of their ``stage_fill`` spans, 1e9
bytes a GB. The waits for a staging buffer (``stage_wait``) and the sends
to the card (``send``) are not in it.

Read in a traced run on the card (a trace with device operations), from
what the program records into each call's ``Searcher.last_finish_split``
while a ``torch.profiler`` runs; None where no call of the window filled
a staging buffer (a program without spans, or text sets all uploaded
before)."""

SPAN = "stage_fill"


def read(ctx):
    td = ctx.trace
    if td is None or not td.device:
        return None
    nbytes = ns = 0
    for c in ctx.calls:
        if c.error is None and c.split.get("spans"):
            nbytes += c.split.get("fill_bytes", 0)
            ns += sum(s[4] - s[3] for s in c.split["spans"] if s[0] == SPAN)
    return nbytes / ns if ns > 0 else None
