"""finish_ms (ms, per layer: the host finish, ``search.py``,
``traceback.py``, ``collector.py``, ``cigar.py``): the mean over the
window's calls of the seconds that the program's
``Searcher.last_finish_split`` gives its finish, read after each
``finish()``: the keys below (on the card "trace" is the traceback
kernel's call, its copy and its host work; "build" the Match and CIGAR
build)."""

#: the seconds keys of ``Searcher.last_finish_split`` that are summed
KEYS = ("filters", "trace", "build")


def read(ctx):
    splits = [c.split for c in ctx.calls if c.error is None and c.split]
    if not splits:
        return None
    return sum(sum(s.get(k, 0.0) for k in KEYS) for s in splits) \
        / len(splits) * 1e3
