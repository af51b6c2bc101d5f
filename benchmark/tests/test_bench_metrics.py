"""The metric arithmetic on synthetic calls, splits and profiler events."""

from __future__ import annotations

import pytest

from benchmark import spec, trace
from benchmark.client import Call, RunContext

MS = 1_000_000  # ns


def _ctx(**kw):
    calls = [Call(0, 0, 10, 40_000_000, submit=0.0, done=0.050,
                  matches=7000,
                  split={"filters": 0.001, "trace": 0.004, "build": 0.015,
                         "unpack": 0.002, "gc_passes": 0}),
             Call(1, 1, 10, 40_000_000, submit=0.020, done=0.110,
                  matches=7100,
                  split={"filters": 0.001, "trace": 0.006, "build": 0.013})]
    td = trace.TraceData(0, 100 * MS, device=[
        ("void (anonymous namespace)::scan_q_meta_kernel<0, 24>("
         "(anonymous namespace)::QArgs)", "kernel", 10 * MS, 30 * MS),
        ("scan_q_meta_kernel<1>", "kernel", 25 * MS, 40 * MS),
        ("Memcpy HtoD (Pinned -> Device)", "memcpy", 0, 4 * MS),
        ("Memcpy DtoH (Device -> Pinned)", "memcpy", 50 * MS, 51 * MS),
        ("emit_words", "kernel", 60 * MS, 70 * MS),
        ("Memset (Device)", "memset", 95 * MS, 110 * MS)],
        host=[("submit", 0, 2 * MS), ("finish", 40 * MS, 60 * MS),
              ("finish", 70 * MS, 95 * MS), ("gc", 71 * MS, 90 * MS)])
    base = dict(cell="c", calls=calls, window_s=0.110, setup_s=7.5,
                peak_bytes=3 * 2**30, pattern_lengths=[24] * 96, strands=2,
                trace=td)
    base.update(kw)
    return RunContext(**base)


def read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_end_to_end():
    ctx = _ctx()
    assert read("throughput_mbp_s", ctx) == pytest.approx(80 / 0.110)
    assert read("call_latency_p95_ms", ctx) == pytest.approx(50 + 0.95 * 40)
    assert read("peak_device_gib", ctx) == 3.0
    assert read("setup_s", ctx) == 7.5
    assert read("peak_device_gib", _ctx(peak_bytes=None)) is None


def test_failed_calls_add_no_bases():
    ctx = _ctx()
    ctx.calls[1].error = "boom"
    assert read("throughput_mbp_s", ctx) == pytest.approx(40 / 0.110)


def test_finish_ms_sums_its_keys():
    assert read("finish_ms", _ctx()) == pytest.approx((20 + 20) / 2)


def test_device_busy_idle_and_upload():
    ctx = _ctx()
    # busy: 0-4, 10-40, 50-51, 60-70, 95-100 (the window ends at 100)
    assert ctx.trace.busy_s() == pytest.approx(0.050)
    assert read("device_idle_pct", ctx) == pytest.approx(50.0)
    assert read("upload_ms", ctx) == pytest.approx(4.0 / 2)
    assert trace.gaps(ctx.trace) == [(4 * MS, 10 * MS), (40 * MS, 50 * MS),
                                      (51 * MS, 60 * MS), (70 * MS, 95 * MS)]


def test_breakdown():
    b = trace.breakdown(_ctx().trace)
    assert b["device_ops"][0] == ["scan_q_meta_kernel", 0.035]
    assert [n for n, _ in b["device_ops"]] == [
        "scan_q_meta_kernel", "emit_words", "Memset", "Memcpy HtoD",
        "Memcpy DtoH"]
    assert b["idle_gaps"][0] == ["finish:gc", 0.025]
    assert b["idle_gaps"][-1][0] == "other"
    assert trace.short_name("void at::native::vectorized_elementwise_kernel"
                            "<4, float>(int)") == "vectorized_elementwise_kernel"


def test_scan_roofline():
    ctx = _ctx()
    words = -(-40_000_000 // 32)
    ops = 96 * 24 * words * 2 * 10 * 2  # two calls
    want = 100 * ops / (132 * 64 * 1.98e9) / 0.035
    assert read("scan_roofline_pct", ctx) == pytest.approx(want)


def test_metrics_find_nothing_without_a_trace():
    ctx = _ctx(trace=None)
    for name in ("upload_ms", "scan_roofline_pct", "device_idle_pct"):
        assert read(name, ctx) is None
    empty = _ctx(trace=trace.TraceData(0, MS))
    for name in ("upload_ms", "scan_roofline_pct", "device_idle_pct"):
        assert read(name, empty) is None


def test_the_roofline_count_is_frozen():
    """The operation count, the bytes rule and both peaks, as derived in
    the metric's file."""
    import importlib.util

    path = spec.ROOT / "benchmark" / "metrics" / "scan_roofline_pct.py"
    s = importlib.util.spec_from_file_location("roofline", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    assert mod.OPS_PER_STEP == 10
    assert mod.WORD_BITS == 32
    assert mod.TEXT_BITS_PER_BASE == 2 and mod.MATCH_BYTES == 8
    assert mod.PEAK_INT32_OPS_S == pytest.approx(1.672704e13)
    assert mod.PEAK_BYTES_S == 3.35e12
    assert mod.SCAN_KERNELS == ("scan_q_meta_kernel", "scan_q_kernel")
    # 312 x 23 bp over 3.12 Gbp on both strands: the operations bound it
    t, by = mod.least_seconds([23] * 312, 3_117_292_070, 2, 16000)
    assert by == "ops" and t == pytest.approx(
        312 * 23 * 97_415_378 * 2 * 10 / 1.672704e13)
    assert "1999" in mod.__doc__ and "LOP3" in mod.__doc__
