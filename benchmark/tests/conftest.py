"""Fixtures of the benchmark's own tests: the two cells cut to sizes the
CPU runs in a second, and the check for a card, made inside a fixture."""

from __future__ import annotations

import pytest

from benchmark import spec


def small_cell(name: str) -> spec.Cell:
    """The cell ``name`` as its files give it, with its patterns, texts,
    pool and check cut to a few hundred bases each."""
    cell = spec.load_cell(name)
    cfg = dict(cell.config)
    if cfg["texts"]["kind"] == "reads":
        cfg["patterns"] = {"count": 6, "length": 16, "suffix": ""}
        cfg["texts"] = {"kind": "reads", "length": {
            "law": "lognormal", "mean": 400, "sigma": 0.8, "min": 60,
            "max": 3000, "seed": 0}}
        cfg["plant"] = {**cfg["plant"], "front_within": 40,
                        "rear_within": 40}
        cell.traffic = {**cell.traffic, "texts_per_call": 30,
                        "pool_calls": 3}
        cell.check = {**cell.check, "sampled_calls": 2, "whole_texts": 5,
                      "min_compared": 20}
    else:
        cfg["patterns"] = {"count": 5, "length": 15, "suffix": "NGG"}
        cfg["texts"] = {"kind": "records", "names": ["a", "b", "c"],
                        "lengths": [3000, 1800, 90]}
        cfg["plant"] = {**cfg["plant"], "every": 400, "edit_span": 12}
        cell.check = {**cell.check, "whole_text_max_bp": 100,
                      "plant_areas": 4, "plant_margin": 20,
                      "random_areas": 3, "area_bp": 200,
                      "text_end_areas": 1, "min_compared": 5}
    cfg["k"] = 2
    cell.config = cfg
    return cell


@pytest.fixture(params=["demux_4k_batches", "offtarget_312_guides"])
def cell(request) -> spec.Cell:
    return small_cell(request.param)


@pytest.fixture
def cuda_device():
    """The card, or a skip where this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
