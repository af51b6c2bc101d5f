"""The port's spans and counters (``sassy_tpu_torch.spans``): the batched
call's record without a profiler (today's keys only), with one (spans on
the submit's, the dispatch thread's and the finish's steps, each inside
its parent), two calls in flight (a record each), a text set shared by
two calls (no second upload or plan), the profiler's clock, and the
record shared by many threads.

The tests marked ``cuda`` skip without a CUDA device; on a GPU machine
without JAX run them without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import sys
import threading

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from sassy_tpu_torch import Searcher, spans

#: the keys a batched call's record has on the CPU with no profiler
#: running, as ``last_finish_split`` had them before spans
CPU_KEYS = {"filters", "gather", "fill", "walk", "unpack", "cigars",
            "match_objects", "build", "gc_passes", "gc_s", "candidates",
            "kept", "windows", "matches"}
#: the keys a record gets only while a profiler runs
TRACED_KEYS = {"call_id", "spans", "texts", "text_bytes", "fill_bytes",
               "pieces", "chunks", "device_waits"}


def _inputs(seed=0, n_texts=30):
    rng = np.random.default_rng(seed)
    reads = [rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
             for n in rng.integers(100, 2000, n_texts)]
    pats = [rng.choice(np.frombuffer(b"ACGT", np.uint8), size=20)
            for _ in range(5)]
    for i, r in enumerate(reads[::3]):
        r[40:60] = pats[i % len(pats)]
    return pats, reads


def _profiled(fn, activities=(ProfilerActivity.CPU,)):
    prof = profile(activities=list(activities))
    prof.start()
    try:
        return fn(), prof
    finally:
        prof.stop()


def _by_name(rec):
    out = {}
    for i, s in enumerate(rec["spans"]):
        out.setdefault(s.name, []).append((i, s))
    return out


def _children(rec, i):
    return {s.name for s in rec["spans"] if s.parent == i}


def test_the_flag_is_the_profilers_and_seen_from_every_thread():
    seen = []

    def look():
        seen.append((autograd_profiler._is_profiler_enabled,
                     "spans" in spans.record()))

    def in_a_thread():
        t = threading.Thread(target=look)
        t.start()
        t.join(10)
        assert not t.is_alive()

    assert spans._profiler is autograd_profiler
    look()
    _profiled(in_a_thread)
    look()
    assert seen == [(False, False), (True, True), (False, False)]
    assert spans.record() == {}


def test_no_spans_and_no_new_keys_without_a_profiler():
    pats, reads = _inputs()
    s = Searcher("dna", rc=True, device="cpu")
    ms = s.search_many(pats, reads, 2)
    sp = s.last_finish_split
    assert ms and set(sp) == CPU_KEYS
    assert sp["matches"] == len(ms)
    assert sp["build"] == pytest.approx(
        sp["unpack"] + sp["cigars"] + sp["match_objects"], rel=1e-9)
    # a traced call counts the same sizes and adds only its own keys
    _profiled(lambda: s.search_many(pats, reads, 2))
    traced = s.last_finish_split
    assert set(traced) - set(sp) <= TRACED_KEYS
    assert set(sp) <= set(traced)
    for key in ("candidates", "kept", "windows", "matches", "gc_passes"):
        assert traced[key] == sp[key]


def test_a_profiled_call_records_its_spans_each_inside_its_parent():
    pats, reads = _inputs()
    s = Searcher("dna", rc=True, device="cpu")
    ms, _ = _profiled(lambda: s.search_many(pats, reads, 2))
    rec = s.last_finish_split
    assert ms and rec["matches"] == len(ms)
    sp = rec["spans"]
    assert sp and all(isinstance(x, spans.Span) for x in sp)
    names = _by_name(rec)
    (i_sub, sub), = names["submit"]
    (i_fin, fin), = names["finish"]
    disp = names["dispatch"]
    assert len(disp) == 2  # one job a strand
    assert sub.thread == fin.thread == threading.current_thread().name
    assert {d.thread for _, d in disp} == {disp[0][1].thread}
    assert disp[0][1].thread.startswith("sassy_tpu_torch-dispatch")
    assert _children(rec, i_sub) == {"encode", "text_set", "enqueue"}
    assert {"groups", "plan", "upload", "pack", "launch",
            "device_wait"} <= _children(rec, disp[0][0])
    assert {"groups", "pack", "launch"} <= _children(rec, disp[1][0])
    assert {"wait", "decode", "filters", "trace", "build"} <= \
        _children(rec, i_fin)
    assert "stage_fill" in _children(rec, names["upload"][0][0])
    # the plan's and the groups' copies to the device are named waits
    assert "device_wait" in _children(rec, names["plan"][0][0])
    for i, _ in names["groups"]:
        assert "device_wait" in _children(rec, i)
    assert {"gather", "fill", "walk"} <= set(names)
    assert {"unpack", "cigars", "match_objects"} <= set(names)
    for i, x in enumerate(sp):
        assert x.start_ns <= x.end_ns and 0 <= x.cpu_ns
        if x.parent >= 0:
            p = sp[x.parent]
            assert p.thread == x.thread and x.parent < i
            assert p.start_ns <= x.start_ns <= x.end_ns <= p.end_ns
    # each job starts after the caller's enqueue span that handed it over
    enq = [x for _, x in names["enqueue"]]
    for (_, d), e in zip(disp, enq):
        assert sub.start_ns <= e.start_ns <= d.start_ns
    assert sub.end_ns <= fin.start_ns
    # one upload serves both strands; the counters count at their spans
    assert rec["fill_bytes"] == rec["text_bytes"] == sum(map(len, reads))
    assert rec["texts"] == len(reads)
    assert rec["chunks"] == len(names["launch"])
    assert rec["device_waits"] == len(names["device_wait"])
    assert rec["pieces"] > 0


def test_two_calls_in_flight_keep_their_own_records():
    pats, reads = _inputs()
    other = _inputs(seed=1, n_texts=7)[1]
    s = Searcher("dna", rc=True, device="cpu")

    def two():
        a = s.search_many_with_fn_async(pats, reads, 2, False, None)
        b = s.search_many_with_fn_async(pats, other, 2, False, None)
        ma = a()
        ra = s.last_finish_split
        mb = b()
        return (ma, ra), (mb, s.last_finish_split)

    ((ma, ra), (mb, rb)), _ = _profiled(two)
    assert ma and ra is not rb and ra["call_id"] != rb["call_id"]
    assert ra["matches"] == len(ma) and rb["matches"] == len(mb)
    assert ra["text_bytes"] == ra["fill_bytes"] == sum(map(len, reads))
    assert rb["text_bytes"] == rb["fill_bytes"] == sum(map(len, other))
    for rec in (ra, rb):
        names = _by_name(rec)
        assert len(names["submit"]) == len(names["finish"]) == 1
        assert len(names["dispatch"]) == 2 and len(names["upload"]) == 1
    ids = {id(x) for x in ra["spans"]}
    assert not ids & {id(x) for x in rb["spans"]}


@pytest.mark.parametrize("traced", [False, True])
def test_a_finish_called_without_a_record_makes_its_own(traced):
    """A strand's candidates handed to ``_finish_many_batched`` without
    the call's record, as the repo's card smoke test does: the finish
    makes a record, publishes it and finds the forward strand's matches."""
    from sassy_tpu_torch import Strand

    pats, reads = _inputs()
    s = Searcher("dna", rc=False, device="cpu")
    want = s.search_many(pats, reads, 2)

    def finish():
        ts = s._text_set(reads)
        codes = [s.profile.encode(p) for p in pats]
        fin = s.batch.candidates_many_flat_async(
            s.profile, codes, ts, 2, s.alpha, s.max_overhang, False)
        flat = fin()
        return s._finish_many_batched(
            [(Strand.FWD, pats, codes, lambda: flat)], ts, 2, None)

    got = _profiled(finish)[0] if traced else finish()
    rec = s.last_finish_split
    assert got == want and rec["matches"] == len(want)
    assert ("spans" in rec) == traced
    if traced:
        assert {"finish", "filters", "build"} <= set(_by_name(rec))


def test_a_shared_text_set_records_no_second_upload_or_plan():
    pats, reads = _inputs()
    s = Searcher("dna", rc=True, device="cpu")

    def twice():
        ts = s._text_set(reads)
        recs = []
        for _ in range(2):
            s._search_many_batched_async(pats, reads, 2, False, True,
                                         textset=ts)()
            recs.append(s.last_finish_split)
        return recs

    (first, second), _ = _profiled(twice)
    assert {"upload", "plan", "pack", "stage_fill"} <= set(_by_name(first))
    assert not {"upload", "plan", "pack", "stage_fill"} & \
        set(_by_name(second))
    assert first["fill_bytes"] == second["text_bytes"]
    assert "fill_bytes" not in second and "pieces" not in second


def test_spans_are_on_the_profilers_clock():
    def inside():
        rec = spans.record()
        with spans.bound(rec), spans.span("outer"):
            with record_function("inner_label"):
                torch.ones(64).sum()
        return rec

    rec, prof = _profiled(inside)
    (outer,) = rec["spans"]
    starts = [ev.start_ns() for ev in prof.profiler.kineto_results.events()
              if ev.name() == "inner_label"]
    assert len(starts) == 1
    assert outer.start_ns <= starts[0] <= outer.end_ns


def test_a_record_shared_by_many_threads_loses_nothing():
    """More threads than cores each bind the one record and nest spans
    and counters in it, with a short switch interval: every span is
    closed, inside its parent on its own thread, and no count is lost."""
    n_threads, rounds = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(rec):
            with spans.bound(rec):
                for _ in range(rounds):
                    with spans.span("outer", n=1):
                        with spans.step(None, "inner"):
                            spans.count(m=2)

        def run():
            rec = spans.record()
            threads = [threading.Thread(target=work, args=(rec,))
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
            return rec

        rec, _ = _profiled(run)
    finally:
        sys.setswitchinterval(interval)
    sp = rec["spans"]
    assert len(sp) == 2 * n_threads * rounds and None not in sp
    assert rec["n"] == n_threads * rounds and rec["m"] == 2 * rec["n"]
    for x in sp:
        if x.name == "inner":
            p = sp[x.parent]
            assert p.name == "outer" and p.thread == x.thread
            assert p.start_ns <= x.start_ns <= x.end_ns <= p.end_ns
        else:
            assert x.parent == -1
    assert spans.current() is None


def test_a_step_adds_its_seconds_without_a_profiler():
    split = {}
    with spans.step(split, "unpack", build=True):
        pass
    with spans.step(split, "cigars", build=True):
        pass
    spans.add(split, windows=3)
    spans.add(None, windows=3)
    spans.count(windows=5)
    assert set(split) == {"unpack", "cigars", "build", "windows"}
    assert split["build"] == pytest.approx(split["unpack"] + split["cigars"])
    assert split["windows"] == 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_kernel_synchronised_in_a_span_runs_inside_it(cuda):
    x = torch.randn(1 << 24, device=cuda)
    torch.cuda.synchronize()

    def inside():
        rec = spans.record()
        with spans.bound(rec), spans.span("outer"):
            (x * 2).sum()
            torch.cuda.synchronize()
        return rec

    rec, prof = _profiled(inside, (ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA))
    (outer,) = rec["spans"]
    from torch.autograd import DeviceType

    kernels = [(ev.start_ns(), ev.start_ns() + ev.duration_ns())
               for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == DeviceType.CUDA]
    assert kernels
    for s, e in kernels:
        assert outer.start_ns <= s <= e <= outer.end_ns


@pytest.mark.cuda
def test_a_card_call_records_its_staged_upload_and_waits(cuda):
    pats, reads = _inputs()
    s = Searcher("dna", rc=True, device="cuda")
    s.search_many(pats, reads, 2)  # builds and warms the kernels
    ms, _ = _profiled(lambda: s.search_many(pats, reads, 2),
                      (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    rec = s.last_finish_split
    names = _by_name(rec)
    assert ms and rec["matches"] == len(ms) and "trace" in rec
    assert {"stage_wait", "stage_fill", "send"} <= \
        _children(rec, names["upload"][0][0])
    assert rec["fill_bytes"] == rec["text_bytes"] == sum(map(len, reads))
    assert rec["device_waits"] == len(names["device_wait"]) >= 3
