"""upload_ms (ms, per layer: the text set, ``ops/batch.py``,
``ops/myers_torch.py`` ``_upload_set``, ``csrc/stage_fill.cc``): the device
time of the host-to-device copies in the traced window, per call of the
window."""

from benchmark.trace import union_ns


def read(ctx):
    td = ctx.trace
    if td is None or not ctx.calls:
        return None
    copies = [(s, e) for name, kind, s, e in td.device
              if kind == "memcpy" and "HtoD" in name]
    if not copies:
        return None
    return union_ns(copies, td.start, td.end) / 1e6 / len(ctx.calls)
