"""The readers of the program's spans on synthetic calls and traces:
``submit_ms``, ``plan_ms``, ``stage_fill_gb_s``, ``dispatch_lock_wait_ms``
and ``idle_in_dispatch_pct``."""

from __future__ import annotations

import pytest

from benchmark import spec, trace
from benchmark.client import Call, RunContext

MS = 1_000_000  # ns
NAMES = ("submit_ms", "plan_ms", "stage_fill_gb_s", "dispatch_lock_wait_ms",
         "idle_in_dispatch_pct")


def span(name, parent, start_ms, end_ms, cpu_ms=None, thread="main"):
    """A span as the program records it: (name, parent, thread, start ns,
    end ns, thread CPU ns)."""
    cpu = end_ms - start_ms if cpu_ms is None else cpu_ms
    return (name, parent, thread, int(start_ms * MS), int(end_ms * MS),
            int(cpu * MS))


def _call_a():
    """Call 0 (window ms 0-50): a submit of 4 ms; one dispatch job of
    20 ms wall, 8 ms CPU, holding a plan of 2 ms, an upload whose
    stage_wait (1 ms wall, 0 CPU) and stage_fill (4 ms wall, 1 ms CPU,
    400 MB) are named waits, and a launch whose device_wait (5 ms wall,
    1 ms CPU) is one; a second job (the reverse strand) of 10 ms wall,
    9 ms CPU, with no plan."""
    d = "sassy_tpu_torch-dispatch_0"
    spans = [
        span("submit", -1, 0, 4),                              # 0
        span("encode", 0, 0, 1),                               # 1
        span("dispatch", -1, 4, 24, cpu_ms=8, thread=d),       # 2
        span("plan", 2, 4, 6, thread=d),                       # 3
        span("upload", 2, 6, 12, cpu_ms=2, thread=d),          # 4
        span("stage_wait", 4, 6, 7, cpu_ms=0, thread=d),       # 5
        span("stage_fill", 4, 7, 11, cpu_ms=1, thread=d),      # 6
        span("launch", 2, 12, 20, cpu_ms=4, thread=d),         # 7
        span("device_wait", 7, 14, 19, cpu_ms=1, thread=d),    # 8
        span("dispatch", -1, 24, 34, cpu_ms=9, thread=d),      # 9
        span("finish", -1, 30, 50),                            # 10
    ]
    return Call(0, 0, 10, 400_000_000, submit=0.0, done=0.050, matches=10,
                split={"filters": 0.001, "call_id": 1, "spans": spans,
                       "fill_bytes": 400_000_000,
                       "text_bytes": 400_000_000})


def _call_b():
    """Call 1 (window ms 50-100): a submit of 6 ms; one dispatch job of
    10 ms wall and 8 ms CPU, with a plan of 4 ms and a stage_fill of 2 ms
    off the CPU (100 MB) straight under it."""
    d = "sassy_tpu_torch-dispatch_0"
    spans = [
        span("submit", -1, 50, 56),
        span("dispatch", -1, 56, 66, cpu_ms=8, thread=d),
        span("plan", 1, 56, 60, thread=d),
        span("stage_fill", 1, 60, 62, cpu_ms=0, thread=d),
        span("finish", -1, 70, 100),
    ]
    return Call(1, 1, 10, 100_000_000, submit=0.050, done=0.100, matches=5,
                split={"filters": 0.001, "call_id": 2, "spans": spans,
                       "fill_bytes": 100_000_000,
                       "text_bytes": 100_000_000})


def _trace():
    """Window 0-100 ms; the card busy 0-10, 20-30, 60-90: idle 10-20,
    30-60 and 90-100 (50% of the window)."""
    return trace.TraceData(0, 100 * MS, device=[
        ("scan_q_meta_kernel", "kernel", 0, 10 * MS),
        ("Memcpy HtoD (Pinned -> Device)", "memcpy", 20 * MS, 30 * MS),
        ("scan_q_meta_kernel", "kernel", 60 * MS, 90 * MS)])


def _ctx(calls=None, td="default"):
    return RunContext(
        cell="c", calls=[_call_a(), _call_b()] if calls is None else calls,
        window_s=0.1, setup_s=1.0, peak_bytes=2**30, pattern_lengths=[23],
        strands=2, trace=_trace() if td == "default" else td)


def read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_submit_ms_is_the_mean_submit_span():
    assert read("submit_ms", _ctx()) == pytest.approx((4 + 6) / 2)


def test_plan_ms_is_the_mean_of_each_calls_summed_plans():
    assert read("plan_ms", _ctx()) == pytest.approx((2 + 4) / 2)
    # a call over a text set planned before records no plan and adds 0
    b = _call_b()
    b.split["spans"] = [s for s in b.split["spans"] if s[0] != "plan"]
    assert read("plan_ms", _ctx([_call_a(), b])) == pytest.approx(1.0)


def test_stage_fill_gb_s_is_bytes_over_fill_seconds():
    # 500 MB in 6 ms
    assert read("stage_fill_gb_s", _ctx()) == pytest.approx(0.5 / 0.006)
    # spans but no fill: nothing to read
    calls = [_call_a()]
    calls[0].split["spans"] = [s for s in calls[0].split["spans"]
                               if s[0] != "stage_fill"]
    assert read("stage_fill_gb_s", _ctx(calls)) is None


def test_dispatch_lock_wait_ms_leaves_out_the_named_waits():
    # call a: jobs off the CPU 12 + 1 ms, less stage_wait 1, stage_fill 3,
    # device_wait 4: 5 ms; call b: 2, less its stage_fill's 2: 0 ms
    assert read("dispatch_lock_wait_ms", _ctx()) == pytest.approx(
        ((12 + 1 - 1 - 3 - 4) + (2 - 2)) / 2)
    # a named wait nested in another counts once
    a = _call_a()
    sp = a.split["spans"]
    sp.append(span("device_wait", 8, 15, 16, cpu_ms=0,
                   thread=sp[2][2]))
    assert read("dispatch_lock_wait_ms", _ctx([a])) == pytest.approx(5.0)
    # the named waits alone: a job that only waits reads 0
    d = "sassy_tpu_torch-dispatch_0"
    only = Call(2, 0, 1, 10, 0.0, done=0.01, matches=0, split={"spans": [
        span("dispatch", -1, 0, 10, cpu_ms=2, thread=d),
        span("device_wait", 0, 1, 9, cpu_ms=0, thread=d)]})
    assert read("dispatch_lock_wait_ms", _ctx([only])) == pytest.approx(0.0)


def test_idle_in_dispatch_pct_is_idle_time_inside_dispatch_spans():
    # dispatch spans 4-24, 24-34, 56-66; idle 10-20, 30-60, 90-100:
    # 10-20, 30-34 and 56-60 overlap, 18 ms of 100
    ctx = _ctx()
    assert read("idle_in_dispatch_pct", ctx) == pytest.approx(18.0)
    assert read("device_idle_pct", ctx) == pytest.approx(50.0)


@pytest.mark.parametrize("seed", range(5))
def test_idle_in_dispatch_pct_is_at_most_device_idle_pct(seed):
    import random

    rng = random.Random(seed)
    dev = []
    for _ in range(40):
        s = rng.randrange(0, 1000)
        dev.append(("k", "kernel", s * MS, (s + rng.randrange(1, 30)) * MS))
    td = trace.TraceData(0, 1000 * MS, device=dev)
    spans = []
    for _ in range(30):
        s = rng.randrange(-50, 1000)
        spans.append(span("dispatch", -1, s, s + rng.randrange(1, 80),
                          thread="d"))
    call = Call(0, 0, 1, 1, 0.0, done=1.0, matches=0,
                split={"spans": spans})
    ctx = _ctx([call], td)
    got = read("idle_in_dispatch_pct", ctx)
    assert 0 < got <= read("device_idle_pct", ctx) + 1e-9
    # brute force over the window's milliseconds
    busy = set()
    for _, _, s, e in dev:
        busy.update(range(s // MS, e // MS))
    inside = set()
    for x in spans:
        inside.update(range(max(0, x[3] // MS), min(1000, x[4] // MS)))
    want = len(inside - busy) / 10
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_a_run_without_spans_reads_none(name):
    """The program's parent records no spans: its calls' splits hold only
    the finish's steps."""
    calls = [Call(0, 0, 1, 1, 0.0, done=0.05, matches=1,
                  split={"filters": 0.001, "build": 0.002})]
    assert read(name, _ctx(calls)) is None
    assert read(name, _ctx([])) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_run_off_the_card_reads_none(name):
    """Without a trace, or with one that holds no device operation (the
    CPU's runs), the spans are not read."""
    assert read(name, _ctx(td=None)) is None
    assert read(name, _ctx(td=trace.TraceData(0, 100 * MS))) is None


def test_failed_calls_are_left_out():
    a, b = _call_a(), _call_b()
    b.error = "boom"
    assert read("submit_ms", _ctx([a, b])) == pytest.approx(4.0)
    assert read("stage_fill_gb_s", _ctx([a, b])) == pytest.approx(
        0.4 / 0.004)


def test_the_manifest_names_them_for_the_three_cells():
    import json

    man = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    per = {m["name"]: m for m in man["per_layer"]}
    cells = ["demux_4k_batches", "offtarget_312_guides", "offtarget_61_guides"]
    layers = {"submit_ms": "Searcher", "plan_ms": "text set",
              "stage_fill_gb_s": "text set",
              "dispatch_lock_wait_ms": "text set",
              "idle_in_dispatch_pct": "device"}
    for name in NAMES:
        m = per[name]
        assert m["source"] == "program_span"
        assert m["moves"] == "throughput_mbp_s"
        assert m["workloads"] == cells and m["layer"] == layers[name]
    cell = spec.load_cell("offtarget_61_guides")
    assert cell.chips == 1 and cell.config["patterns"]["count"] == 61
    assert {m["name"] for m in cell.per_layer} == set(NAMES)
    old = spec.load_cell("offtarget_312_guides").config
    assert {k: v for k, v in cell.config.items()
            if k not in ("name", "source", "deployment", "patterns",
                         "assumed")} == {
        k: v for k, v in old.items()
        if k not in ("name", "source", "deployment", "patterns", "assumed")}
    assert cell.config["patterns"] == {**old["patterns"], "count": 61}
