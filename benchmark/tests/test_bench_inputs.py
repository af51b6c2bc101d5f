"""The generator makes the same inputs from the same seed, and the same
sizes from every seed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import inputs, spec
from benchmark.reference import dp
from benchmark.tests.conftest import small_cell


def _make(cell, seed):
    return inputs.make_inputs(cell.config, cell.traffic, seed, "cpu")


def test_same_seed_same_inputs(cell):
    a, b = _make(cell, 2**31 + 12345), _make(cell, 2**31 + 12345)
    assert np.array_equal(a.buf, b.buf)
    assert all(np.array_equal(x, y) for x, y in zip(a.patterns, b.patterns))
    assert np.array_equal(a.plants, b.plants)
    assert np.array_equal(a.lengths, b.lengths)


def test_other_seed_same_sizes(cell):
    a, b = _make(cell, 7), _make(cell, -8)
    assert not np.array_equal(a.buf, b.buf)
    assert sorted(a.lengths.tolist()) == sorted(b.lengths.tolist())
    # each call has the same sizes, in another order
    assert sorted(sorted(a.lengths[c].tolist()) for c in a.calls) == \
        sorted(sorted(b.lengths[c].tolist()) for c in b.calls)
    assert abs(len(a.plants) - len(b.plants)) <= 2 + len(a.plants) // 50


def test_texts_are_read_only_acgt(cell):
    x = _make(cell, 3)
    assert not x.buf.flags.writeable
    assert set(np.unique(x.buf).tolist()) <= set(b"ACGT")
    views = x.call_texts(0)
    assert all(not v.flags.writeable for v in views)
    assert views[0] is not x.call_texts(0)[0]


def test_plants_hold_their_copies(cell):
    """Each planted copy is in its text, as the pattern (or its reverse
    complement) within its edits."""
    x = _make(cell, 11)
    for t, start, end, q, orient, edits in x.plants.tolist():
        seq = x.text(t)[start:end]
        if orient:
            seq = dp.complement(seq)[::-1]
        c = dp.last_row(torch.from_numpy(dp.encode(x.patterns[q])[None]),
                        torch.from_numpy(dp.encode(seq)[None]))[0, -1]
        assert int(c) <= edits


def test_read_lengths_follow_the_law():
    law = {"law": "lognormal", "mean": 10000, "sigma": 0.8, "min": 200,
           "max": 100000, "seed": 0}
    n = inputs.read_lengths(law, 32000)
    assert n.min() >= 200 and n.max() <= 100000
    assert abs(n.mean() - 10000) < 300


def test_cells_shares_as_configured():
    cell = small_cell("demux_4k_batches")
    x = _make(cell, 5)
    tagged = {p[0] for p in x.plants.tolist()}
    assert len(tagged) == round(0.9 * len(x.lengths))


@pytest.mark.parametrize("name", ["nanopore_barcodes_96x24",
                                  "crispr_guides_chm13"])
def test_configs_state_their_sizes(name):
    cfg = spec._json(spec.ROOT / "benchmark" / "configs" / f"{name}.json")
    assert cfg["reduced"] == [] and cfg["assumed"] and cfg["source"]
    if cfg["texts"]["kind"] == "records":
        assert sum(cfg["texts"]["lengths"]) == 3_117_292_070
        assert len(cfg["texts"]["names"]) == 25
