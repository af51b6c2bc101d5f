"""The port's copies of ``examples/`` (``sassy_tpu_torch.examples``) on the
CPU against the JAX package's examples: the same printed lines (timings
and temporary paths masked) and the same match sets, recorded from the
JAX example's own ``Searcher`` calls. ``modes`` runs 512 single searches,
over a minute on the CPU on either side, so its test shrinks the
workload through the port's module constants and holds the three modes
to the same calls on the JAX package's ``Searcher``."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import sassy_tpu
from sassy_tpu_torch.examples import (
    all_vs_all_barcodes,
    genome_scan_resume,
    modes,
    search_all_alignments,
)
from test_torch_cuda import _same

REPO = Path(__file__).resolve().parent.parent


def _reference(name: str, recorded: list, tmp_path: Path | None = None):
    """The JAX example ``examples/<name>.py`` as a module whose Searcher
    records every result (on the XLA engine: "auto" would pick the Pallas
    kernel in interpret mode), its scratch files under ``tmp_path``."""
    spec = importlib.util.spec_from_file_location(
        f"ref_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Recording(sassy_tpu.Searcher):
        def __init__(self, *a, engine="xla", **kw):
            super().__init__(*a, engine="xla", **kw)

        def search_many(self, *a, **kw):
            out = super().search_many(*a, **kw)
            recorded.append(out)
            return out

        def search_all_alignments(self, *a, **kw):
            out = super().search_all_alignments(*a, **kw)
            recorded.append(out)
            return out

    mod.Searcher = Recording
    if tmp_path is not None:
        mod.Path = lambda p: tmp_path if p == "/tmp/sassy_example" else Path(p)
    return mod


def _lines(text: str) -> list[str]:
    """Printed lines with timings and temporary paths masked."""
    text = re.sub(r" +\d+\.\d+ ?m?s", " <time>", text)
    return re.sub(r"\(checkpoint: [^)]*\)", "(checkpoint)", text).splitlines()


def test_all_vs_all_barcodes_equals_jax_example(capsys):
    got = all_vs_all_barcodes.main(device="cpu")
    printed = capsys.readouterr().out
    recorded = []
    _reference("all_vs_all_barcodes", recorded).main()
    assert _lines(printed) == _lines(capsys.readouterr().out)
    _same(got, recorded[0])
    assert len(got) >= 64  # every barcode finds itself


def test_search_all_alignments_equals_jax_example(capsys):
    got = search_all_alignments.main(device="cpu")
    printed = capsys.readouterr().out
    recorded = []
    _reference("search_all_alignments", recorded).main()
    assert _lines(printed) == _lines(capsys.readouterr().out)
    assert len(got) == len(recorded[0]) > 0
    for a, b in zip(got, recorded[0]):
        _same(a, b)


def test_genome_scan_resume_equals_jax_example(capsys, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    tsv, n = genome_scan_resume.main(device="cpu", workdir=tmp_path / "port")
    printed = capsys.readouterr().out
    _reference("genome_scan_resume", [], tmp_path / "ref").main()
    assert _lines(printed) == _lines(capsys.readouterr().out)
    assert tsv == (tmp_path / "ref" / "matches.tsv").read_text()
    assert tsv.count("\t50000\t50023\n") == 4 and n == 4  # the planted sites


def test_modes_equal_jax_searcher(capsys, monkeypatch):
    monkeypatch.setattr(modes, "N_PATTERNS", 4)
    monkeypatch.setattr(modes, "N_TEXTS", 5)
    monkeypatch.setattr(modes, "TEXT_LEN", 300)
    monkeypatch.setattr(modes, "K", 8)
    single, many, encoded = modes.main(device="cpu")
    printed = _lines(capsys.readouterr().out)
    rng = np.random.default_rng(0)
    pats = [bytes(rng.choice(modes.BASES, size=24)) for _ in range(4)]
    texts = [bytes(rng.choice(modes.BASES, size=300)) for _ in range(5)]
    ref = sassy_tpu.Searcher(sassy_tpu.profiles.Iupac(), rc=True,
                             engine="xla")
    _same(single, [m for p in pats for t in texts for m in ref.search(p, t, 8)])
    _same(many, ref.search_many(pats, texts, 8))
    enc = ref.encode_patterns(pats)
    _same(encoded, [m for t in texts
                    for m in ref.search_encoded_patterns(enc, t, 8)])
    assert len(single) == len(many) > 0
    assert printed == [
        f"      single (pair loop): <time>, {len(single)} matches",
        f"   search_many (batched): <time>, {len(many)} matches",
        f"        encoded patterns: <time>, {len(encoded)} matches",
    ]


@pytest.mark.parametrize("example", [all_vs_all_barcodes, modes,
                                     search_all_alignments,
                                     genome_scan_resume])
def test_examples_default_to_cuda(example):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main()
