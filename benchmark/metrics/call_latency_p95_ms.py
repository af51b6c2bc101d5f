"""call_latency_p95_ms (ms, per layer: ``search.Searcher``, host clock): the
95th percentile, by linear interpolation, over every call of the window
of the time from its submission to its Match list in hand. A per-layer
metric, moving throughput_mbp_s: the card is idle for most of the window
of the cell that reports it, so the closed loop runs the host at its
capacity and the tail swings with the smallest change there."""

import numpy as np


def read(ctx):
    if not ctx.calls:
        return None
    lat = [(c.done - c.submit) * 1e3 for c in ctx.calls]
    return float(np.percentile(lat, 95))
