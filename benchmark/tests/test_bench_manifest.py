"""The manifest, the files it names, and what may be imported."""

from __future__ import annotations

import ast
import json
import shutil

import pytest

from benchmark import spec
from benchmark.run import FORBIDDEN

BENCH = spec.ROOT / "benchmark"


def _manifest():
    return json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def test_every_name_has_its_file():
    man = _manifest()
    for c in man["workloads"]:
        cell = spec.load_cell(c["name"])
        assert cell.chips == 1 and cell.end_to_end and cell.per_layer
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for c in man["configs"]:
        assert json.loads((spec.ROOT / c["file"]).read_text())["source"] \
            == c["source"]


def test_cells_report_what_the_manifest_asks():
    man = _manifest()
    names = {c["name"] for c in man["workloads"]}
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) <= 16
    for cell in names:
        c = spec.load_cell(cell)
        assert {m["name"] for m in c.end_to_end} - {"setup_s"}
        assert all(m["moves"] in e2e for m in c.per_layer)


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    """A later change adds a cell, its mix and a per-layer metric as new
    files and manifest entries only; the harness finds them by name."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = _manifest()
    man["workloads"].append({
        "name": "demux_whole_run", "config": "nanopore_barcodes_96x24",
        "traffic": "read_run_33400", "chips": 1, "why": "a whole run"})
    man["per_layer"].append({
        "name": "calls_in_window", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "Searcher",
        "moves": "throughput_mbp_s", "workloads": ["demux_whole_run"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    b = tmp_path / "benchmark"
    traffic = json.loads((b / "traffic" / "read_files_4000.json").read_text())
    traffic.update(texts_per_call=33400, pool_calls=1)
    (b / "traffic" / "read_run_33400.json").write_text(json.dumps(traffic))
    own = json.loads((b / "workloads" / "demux_4k_batches.json").read_text())
    own["traffic"] = "read_run_33400"
    (b / "workloads" / "demux_whole_run.json").write_text(json.dumps(own))
    (b / "metrics" / "calls_in_window.py").write_text(
        "def read(ctx):\n    return len(ctx.calls) or None\n")
    cell = spec.load_cell("demux_whole_run", root=tmp_path)
    assert cell.traffic["texts_per_call"] == 33400
    assert [m["name"] for m in cell.per_layer][-1] == "calls_in_window"
    assert "calls_in_window" not in {
        m["name"] for m in spec.load_cell("demux_4k_batches",
                                          root=tmp_path).per_layer}
    read = spec.metric_reader("calls_in_window", root=tmp_path)
    assert read(type("Ctx", (), {"calls": [1, 2, 3]})) == 3


def test_a_cell_file_that_disagrees_is_refused(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    own = tmp_path / "benchmark" / "workloads" / "demux_4k_batches.json"
    d = json.loads(own.read_text())
    d["traffic"] = "genome_screen"
    own.write_text(json.dumps(d))
    with pytest.raises(ValueError):
        spec.load_cell("demux_4k_batches", root=tmp_path)
    with pytest.raises(KeyError):
        spec.load_cell("no_such_cell", root=tmp_path)


def _imports(path):
    """(top-level name, relative level) of every import in a file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: sassy_tpu_torch is allowed where
    sassy_tpu is not."""
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        for name, level in _imports(f):
            assert level or name not in FORBIDDEN, f"{f}: imports {name}"


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        for name, level in _imports(f):
            assert name != "sassy_tpu_torch", f"{f}: imports {name}"
            assert level <= 1, f"{f}: imports from outside the reference"
            assert level or name in {"__future__", "dataclasses", "numpy",
                                     "torch"}, f"{f}: imports {name}"


def test_the_forbidden_names_are_whole_names():
    assert "sassy_tpu" in FORBIDDEN and "sassy_tpu_torch" not in FORBIDDEN
    assert {"jax", "jaxlib", "flax"} <= set(FORBIDDEN)
