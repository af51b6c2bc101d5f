"""What the profiler saw in the measured window, reduced to intervals.

``from_profiler`` keeps the device's operations (kernels, copies, memsets)
and the benchmark's own host labels (``window``, ``submit``, ``finish``)
from a ``torch.profiler`` run, as (name, start, end) in nanoseconds of one
clock. The readers in ``metrics/`` and the result line's ``breakdown``
take their numbers from a ``TraceData``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["TraceData", "from_profiler", "union_ns", "gaps", "breakdown",
           "short_name", "LABELS"]

#: the host labels the benchmark puts around its own code
LABELS = ("window", "submit", "finish")


@dataclass
class TraceData:
    """The traced window ``start``..``end`` (ns), the device's operations
    in it as (name, kind, start, end) with kind "kernel", "memcpy" or
    "memset", and the host labels as (label, start, end): the benchmark's
    ``submit`` and ``finish``, and ``gc`` for the collector's passes."""

    start: int
    end: int
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device
        (the union of their intervals)."""
        return union_ns([(s, e) for _, _, s, e in self.device],
                        self.start, self.end) / 1e9


def _kind(name: str) -> str:
    """A device operation's kind, from its name."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def from_profiler(prof) -> TraceData:
    """The ``TraceData`` of a finished ``torch.profiler.profile``: its
    window is the span of the host label ``window``."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.is_user_annotation():
            if ev.device_type() == DeviceType.CPU and name in LABELS:
                host.append((name, start, end))
        elif ev.device_type() == DeviceType.CUDA:
            device.append((name, _kind(name), start, end))
    win = [h for h in host if h[0] == "window"]
    if not win:
        raise ValueError("the trace holds no 'window' label")
    _, start, end = win[0]
    return TraceData(start, end, device,
                     [h for h in host if h[0] != "window"])


def union_ns(intervals, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] that the union of ``intervals`` covers."""
    total, reach = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total


def gaps(td: TraceData) -> list:
    """The window's idle gaps on the device, as (start, end)."""
    out, reach = [], td.start
    for s, e in sorted((s, e) for _, _, s, e in td.device):
        if s > reach:
            out.append((reach, min(s, td.end)))
        reach = max(reach, e)
        if reach >= td.end:
            break
    if reach < td.end:
        out.append((reach, td.end))
    return [(s, e) for s, e in out if e > s]


def _label(td: TraceData, s: int, e: int) -> str:
    """The host label that covers most of [s, e], else "other"; with
    ":gc" where the collector ran for more than half of it."""
    best, cover, in_gc = "other", 0, 0
    for name, hs, he in td.host:
        c = min(e, he) - max(s, hs)
        if name == "gc":
            in_gc += max(0, c)
        elif c > cover:
            best, cover = name, c
    return best + (":gc" if 2 * in_gc > e - s else "")


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template and
    arguments: "void (anonymous namespace)::scan_q_meta_kernel<0>(QArgs)"
    is "scan_q_meta_kernel"."""
    short = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    short = short.split("(")[0].split("<")[0].strip()
    return short.rsplit("::", 1)[-1] or name


def breakdown(td: TraceData, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps, each named by what the host was doing then."""
    by_name: dict = {}
    for name, _, s, e in td.device:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0) + max(
            0, min(e, td.end) - max(s, td.start))
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    idle = sorted(gaps(td), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": [[_label(td, s, e), (e - s) / 1e9] for s, e in idle]}
