"""Whole runs at small sizes: the result line, the controls and the faults.

The runs here skip the harness's look for a card (``run_cell`` on the
CPU, where the program runs its kernels' plain versions); the card's own
runs are the last test, which skips without one.
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import run
from benchmark.controls import CONTROLS, program
from benchmark.tests.conftest import small_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cell, seed=20240917, trace=False, factory=None, device="cpu"):
    return run.run_cell(cell, seed, 0.3, trace, device, factory)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(cell, trace):
    r = _run(cell, trace=trace)
    keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(r) == keys
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    got = set(r["metrics"])
    if trace:
        # the others read the card's trace
        want = {"finish_ms"}
        if cell.name == "demux_4k_batches":
            want.add("call_latency_p95_ms")
        assert got == want
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == {"throughput_mbp_s", "setup_s"}  # and the card's peak
    for c in r["checks"].values():
        assert set(c) <= {"value", "limit", "at_least"}
    assert r["checks"]["compared_matches"]["value"] >= \
        cell.check["min_compared"]
    json.dumps(r)


def test_the_same_seed_gives_the_same_checks(cell):
    a, b = _run(cell, seed=99), _run(cell, seed=99)
    assert a["checks"]["compared_matches"] == b["checks"]["compared_matches"]


@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_controls_are_not_correct(cell, control):
    r = _run(cell, factory=CONTROLS[control])
    assert r["correct"] is False
    assert r["checks"]["mismatched_matches"]["value"] > 0


class Broken:
    """The program with a fault planted in its timed path."""

    def __init__(self, inner, fault: str):
        self.inner, self.fault, self.prev = inner, fault, None

    @property
    def last_finish_split(self):
        return self.inner.last_finish_split

    def _finish(self, fin):
        def finish():
            ms = fin()
            if self.fault == "stale":  # the last call's answer again
                ms, self.prev = (self.prev if self.prev is not None
                                 else ms), ms
            elif self.fault == "altered" and ms:  # one answer changed
                ms[len(ms) // 2].cost += 1
            elif self.fault == "empty":
                ms = []
            return ms
        return finish

    def _texts(self, texts):
        # half of the batch left out
        return texts[:len(texts) // 2] if self.fault == "half" else texts

    def search_many(self, patterns, texts, k):
        return self._finish(lambda: self.inner.search_many(
            patterns, self._texts(texts), k))()

    def search_many_with_fn_async(self, patterns, texts, k, all_minima, fn):
        return self._finish(self.inner.search_many_with_fn_async(
            patterns, self._texts(texts), k, all_minima, fn))


FAULTS = [("demux_4k_batches", f) for f in ("stale", "half", "altered",
                                            "empty")] + [
    # every call of the genome cell searches the same texts, so an answer
    # kept from the last call is a right one there
    ("offtarget_312_guides", f) for f in ("half", "altered", "empty")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_faults_are_not_correct(name, fault):
    cell = small_cell(name)
    r = _run(cell, factory=lambda cfg, dev: Broken(program(cfg, dev), fault))
    assert r["correct"] is False


def test_no_card_no_result(capsys):
    """Without a card a run prints no result and exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "demux_4k_batches", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_an_unknown_cell_gives_no_result(capsys):
    assert run.main(["--workload", "no_such", "--seed", "1", "--seconds",
                     "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_program_correct_and_controls_not_on_the_card(cell, cuda_device):
    assert _run(cell, device=cuda_device)["correct"] is True
    for control in CONTROLS.values():
        assert _run(cell, device=cuda_device, factory=control)["correct"] \
            is False
