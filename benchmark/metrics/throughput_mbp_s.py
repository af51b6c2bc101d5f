"""throughput_mbp_s (Mbp/s, end to end, host clock): the text bases of all
calls completed in the window over the window's length, from the first
submission to the last completion. A text's bases count once, not once a
strand, as the reference's benchmarks count read and genome bases."""


def read(ctx):
    done = [c for c in ctx.calls if c.error is None]
    if not done or ctx.window_s <= 0:
        return None
    return sum(c.bases for c in done) / ctx.window_s / 1e6
