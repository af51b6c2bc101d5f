"""The closed loop of one client, and what the metric readers are given.

The client keeps the traffic's number of calls in flight: it submits a
call, and once that many are in flight it waits for the oldest one's
matches before submitting the next, so call N + 1 is submitted before N's
``finish()`` is called. It stops submitting once ``seconds`` have passed
since the first submission and waits for the calls still in flight; the
window runs from the first submission to the last completion.
"""

from __future__ import annotations

import contextlib
import gc
import time
import traceback
from collections import deque
from dataclasses import dataclass, field

__all__ = ["Call", "RunContext", "GcWatch", "run_loop"]


@dataclass
class Call:
    """One call: its place in submission order, the pool call whose texts
    it searched, their count and bases, its submission, the return of the
    submitting call and its completion (``time.perf_counter``), its match
    count and the program's split of its host finish; ``error`` holds the
    traceback of a call that raised."""

    index: int
    batch: int
    texts: int
    bases: int
    submit: float
    submitted: float = 0.0
    done: float = 0.0
    matches: int = -1
    split: dict = field(default_factory=dict)
    error: str | None = None


@dataclass
class RunContext:
    """What a metric's ``read(ctx)`` is given: the window's calls, its
    length, the set-up's seconds, the device's peak bytes (None off a
    card), each pattern's length, the strands searched and, in a traced
    run, the ``trace.TraceData`` of the window."""

    cell: str
    calls: list
    window_s: float
    setup_s: float
    peak_bytes: int | None
    pattern_lengths: list
    strands: int
    trace: object = None


class GcWatch:
    """The collector's passes while it is entered: ``passes`` holds
    (generation, start, end) in ``time.perf_counter`` seconds and
    ``spans`` (start, end) in nanoseconds of the profiler's clock (the
    Unix epoch)."""

    def __init__(self):
        self.passes, self.spans = [], []
        self._t = None

    def _callback(self, phase, info) -> None:
        if phase == "start":
            self._t = (time.perf_counter(), time.time_ns())
        elif self._t is not None:
            self.passes.append((info["generation"], self._t[0],
                                time.perf_counter()))
            self.spans.append((self._t[1], time.time_ns()))
            self._t = None

    def __enter__(self) -> "GcWatch":
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._callback)


def _submit_fn(searcher, api: str, patterns, k: int):
    """Submit one call of ``api`` over ``texts``; returns its finish."""
    if api == "search_many_with_fn_async":
        return lambda texts: searcher.search_many_with_fn_async(
            patterns, texts, k, False, None)
    if api == "search_many":
        return lambda texts: lambda: searcher.search_many(patterns, texts, k)
    raise ValueError(f"unknown api {api!r}")


def run_loop(searcher, inputs, config: dict, traffic: dict,
             seconds: float | None = None, max_calls: int | None = None,
             labels: bool = False, on_done=None) -> list:
    """Run the client until ``seconds`` have passed since the first
    submission or ``max_calls`` were submitted, whichever comes first.
    Returns the completed calls in order; ``on_done(call, matches)`` sees
    each (matches None where the call raised). ``labels``: mark the
    client's ``submit`` and ``finish`` for the profiler."""
    from torch.profiler import record_function

    def label(name):
        return record_function(name) if labels else contextlib.nullcontext()

    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError("the client runs alone, in a closed loop")
    depth = traffic["in_flight"]
    pool = len(inputs.calls)
    fixed = None if traffic["new_arrays"] else [
        inputs.call_texts(c) for c in range(pool)]
    bases = [int(inputs.lengths[c].sum()) for c in inputs.calls]
    submit = _submit_fn(searcher, traffic["api"], inputs.patterns,
                        config["k"])
    done, pending = [], deque()
    t0 = None
    i = 0
    while True:
        now = time.perf_counter()
        more = ((max_calls is None or i < max_calls)
                and (seconds is None or t0 is None or now - t0 < seconds))
        if more and len(pending) < depth:
            b = i % pool
            texts = fixed[b] if fixed is not None else inputs.call_texts(b)
            call = Call(i, b, len(texts), bases[b], time.perf_counter())
            t0 = call.submit if t0 is None else t0
            with label("submit"):
                try:
                    fin = submit(texts)
                except Exception:  # the call failed; the client goes on
                    fin, call.error = None, traceback.format_exc()
            call.submitted = time.perf_counter()
            pending.append((call, fin))
            i += 1
            continue
        if not pending:
            return done
        call, fin = pending.popleft()
        matches = None
        with label("finish"):
            if fin is not None:
                try:
                    matches = fin()
                except Exception:  # the call failed; the client goes on
                    call.error = traceback.format_exc()
        call.done = time.perf_counter()
        if matches is not None:
            call.matches = len(matches)
            call.split = dict(getattr(searcher, "last_finish_split", {}))
        done.append(call)
        if on_done is not None:
            on_done(call, matches)
