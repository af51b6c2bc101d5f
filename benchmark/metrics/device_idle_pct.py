"""device_idle_pct (%, per layer: the device): the share of the traced
window in which no kernel, copy or memset runs on the card, from the union
of the device's intervals in the profiler's timeline."""


def read(ctx):
    td = ctx.trace
    if td is None or not td.device or td.window_s <= 0:
        return None
    return 100.0 * (1.0 - td.busy_s() / td.window_s)
