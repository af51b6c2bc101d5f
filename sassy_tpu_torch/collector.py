"""The cyclic garbage collector held off during the host finish's builds.

A call's host finish makes a few Python objects a match: its ``Match``,
its ``Cigar`` and the Cigar's list of runs. With the collector on, a pass
runs every ``gc.get_threshold()[0]`` allocations and walks every young
object built so far, and the older generations' passes walk what the
process holds, so that a build's cost grows faster than its matches.
``paused`` holds the collector off for one build (none of its objects
can be garbage before the build returns them) and counts the passes that
ran in it all the same, from ``gc.callbacks``' start and stop of each
pass, into the finish's split.

Builds may run in two threads at once (the CLI's dispatch thread and its
main thread each finish calls): the first to enter turns the collector
off, if it was on, and the last to leave turns it on again; a build never
turns it on while another holds it off, never calls ``gc.collect()``, and
leaves a collector that was off as it was.
"""

from __future__ import annotations

import gc
import threading
import time
from contextlib import contextmanager

__all__ = ["paused"]

_lock = threading.Lock()
#: builds inside ``paused`` now, in every thread
_held = 0
#: whether the first of them turned the collector off
_turned_off = False
#: passes seen while a build was held: their count and seconds
_passes = [0, 0.0]
#: the clock at the start of the pass that runs now, else None
_started: list = [None]


def _on_pass(phase: str, info: dict) -> None:
    if phase == "start":
        _started[0] = time.perf_counter()
    elif _started[0] is not None:
        _passes[0] += 1
        _passes[1] += time.perf_counter() - _started[0]
        _started[0] = None


@contextmanager
def paused(split: dict | None = None):
    """Hold the collector off for the block, and count the passes that
    run in it anyway (another thread's ``gc.collect()``): their number
    into ``split["gc_passes"]`` and their seconds into ``split["gc_s"]``
    (``split`` None: nothing). The collector's state before the first of
    the blocks that overlap comes back after the last, also when one
    raises."""
    global _held, _turned_off
    with _lock:
        if not _held:
            _turned_off = gc.isenabled()
            if _turned_off:
                gc.disable()
            gc.callbacks.append(_on_pass)
        _held += 1
    n0, s0 = _passes
    try:
        yield
    finally:
        n1, s1 = _passes
        with _lock:
            _held -= 1
            if not _held:
                if _on_pass in gc.callbacks:
                    gc.callbacks.remove(_on_pass)
                if _turned_off:
                    gc.enable()
        if split is not None:
            split["gc_passes"] = split.get("gc_passes", 0) + n1 - n0
            split["gc_s"] = split.get("gc_s", 0.0) + s1 - s0
