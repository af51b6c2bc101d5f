"""Find what the benchmark runs by name.

``BENCHMARK.json`` at the root names the cells, their configurations and
traffic mixes, and the metrics. Each of those has a file of its own under
``benchmark/``: a configuration the file its entry names, a traffic mix
``traffic/<name>.json``, a cell ``workloads/<name>.json`` (the sampling of
its check) and a metric ``metrics/<name>.py``, whose ``read(ctx)`` takes the
metric from a run (None where it finds nothing to read). A cell, mix or
metric is added by adding its file and its entry; no code names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["Cell", "load_cell", "metric_reader", "ROOT"]

#: the checkout's root: the benchmark's folder is ``ROOT / "benchmark"``
ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    """One cell with everything its run needs."""

    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    #: the manifest's metric entries this run reports: the end-to-end ones
    #: of the cell, or with ``--trace 1`` its per-layer ones
    end_to_end: list
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root / "BENCHMARK.json"``. Raises KeyError for
    a name the manifest lacks and ValueError where the cell's own file
    names another configuration or mix than the manifest does."""
    manifest = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _json(root / configs[cell["config"]]["file"])
    own = _json(root / "benchmark" / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if own[key] != cell[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{own[key]!r}, BENCHMARK.json {cell[key]!r}")
    traffic = _json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
    return Cell(
        name=name, chips=cell["chips"], config=config, traffic=traffic,
        check=own["check"],
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, name)])


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
