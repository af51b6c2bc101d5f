"""The one place the port times a step of a call.

Each batched call (``Searcher.search_many`` and its kin) has a record, a
dict made at its entry and published as ``Searcher.last_finish_split``
when its ``finish()`` ends. ``step`` adds a step's seconds to the record
under the step's name (and under "build" for the Match build's steps), and
``add`` adds sizes: those keys are always there. While a
``torch.profiler`` runs, the record also gets "call_id", counters
(``count``: ``add`` only while recording) and "spans": one ``Span`` for
each ``span`` or ``step`` entered, from whichever thread ran it, on the
profiler's clock (Unix-epoch nanoseconds, ``time.time_ns()``); a span
takes its place in the list when it starts (None until it ends), so the
list is whole once the call's ``finish()`` returns. With no profiler
running, a span costs one read of the profiler's flag
(``torch.autograd.profiler._is_profiler_enabled``, set in every thread
while a profiler runs) and an empty shared context, and a step that and
its accumulation.

A thread writes into the record that it has bound (``bound``): the
caller's thread for the call's submit and its finish, the dispatch thread
for each of the call's dispatch jobs (``handoff`` carries the record over).
Span and counter writes take one lock, so the two threads can share a
record.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _profiler

__all__ = ["Span", "record", "bound", "current", "handoff", "span", "step",
           "add", "count"]


class Span(NamedTuple):
    """One timed step: its name, the index in the record's "spans" of the
    span it ran inside on the same thread (-1: none), the thread's name,
    its start and end in Unix-epoch ns (the profiler's clock), and the CPU
    ns its thread spent in it (as fine as the platform's thread CPU clock,
    which some kernels advance only in scheduler ticks)."""

    name: str
    parent: int
    thread: str
    start_ns: int
    end_ns: int
    cpu_ns: int


_IDS = itertools.count(1)
_LOCK = threading.Lock()
_local = threading.local()
_OFF = contextlib.nullcontext()


def record() -> dict:
    """A new call's record: empty, or while recording its "call_id" and
    an empty "spans"."""
    if not _profiler._is_profiler_enabled:
        return {}
    return {"call_id": next(_IDS), "spans": []}


def current() -> dict | None:
    """The record this thread has bound, else None."""
    return getattr(_local, "rec", None)


class bound:
    """Bind ``rec`` to this thread for the block: its steps, spans and
    counters go there; the binding before comes back after."""

    __slots__ = ("rec", "saved")

    def __init__(self, rec: dict | None):
        self.rec = rec

    def __enter__(self) -> dict | None:
        self.saved = (getattr(_local, "rec", None),
                      getattr(_local, "stack", None))
        _local.rec, _local.stack = self.rec, []
        return self.rec

    def __exit__(self, *exc) -> None:
        _local.rec, _local.stack = self.saved


def handoff() -> dict | None:
    """This thread's record, for a job handed to another thread while
    recording, else None."""
    if not _profiler._is_profiler_enabled:
        return None
    rec = getattr(_local, "rec", None)
    return rec if rec is not None and "spans" in rec else None


def _open(name: str):
    """Start a span in the bound record (None where there is none to
    record into)."""
    rec = getattr(_local, "rec", None)
    spans = rec.get("spans") if rec is not None else None
    if spans is None:
        return None
    stack = _local.stack
    with _LOCK:
        i = len(spans)
        spans.append(None)
    parent = stack[-1] if stack else -1
    stack.append(i)
    # the CPU clock read inside the wall clock's interval
    return (spans, i, name, parent, threading.current_thread().name,
            time.time_ns(), time.thread_time_ns())


def _close(o) -> None:
    cpu, end = time.thread_time_ns(), time.time_ns()
    spans, i, name, parent, thread, start, cpu0 = o
    _local.stack.pop()
    spans[i] = Span(name, parent, thread, start, end, cpu - cpu0)


def span(name: str, **counts):
    """A span of the block, in the bound record, while recording; its
    ``counts`` added to the record's counters (``count``) at its start."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if counts:
        count(**counts)
    return step(None, name)


class step:
    """Time the block: its seconds added to ``split[key]`` (and to
    ``split["build"]`` with ``build``; ``split`` None: nothing), and
    while recording a span named ``key`` in the bound record."""

    __slots__ = ("split", "key", "build", "o", "t0")

    def __init__(self, split: dict | None, key: str, build: bool = False):
        self.split, self.key, self.build = split, key, build

    def __enter__(self) -> None:
        self.o = _open(self.key) if _profiler._is_profiler_enabled else None
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        split = self.split
        if split is not None:
            split[self.key] = split.get(self.key, 0.0) + dt
            if self.build:
                split["build"] = split.get("build", 0.0) + dt
        if self.o is not None:
            _close(self.o)


def add(split: dict | None, **sizes) -> None:
    """Add each of ``sizes`` to its key of ``split`` (None: nothing): the
    finish's sizes, each written by the caller's thread alone."""
    if split is not None:
        for name, n in sizes.items():
            split[name] = split.get(name, 0) + n


def count(**counts) -> None:
    """While recording, ``add`` ``counts`` to the bound record, under the
    lock: both threads count some of them."""
    if _profiler._is_profiler_enabled:
        rec = getattr(_local, "rec", None)
        if rec is not None and "spans" in rec:
            with _LOCK:
                add(rec, **counts)
