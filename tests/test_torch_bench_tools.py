"""The port's measurement tools on the CPU, at tiny sizes: ``tools.bench``
(the headline), ``bench_oneshot``, ``bench_traceback``,
``bench_io_overlap`` and ``profile_readset``. Each runs with
``--device cpu`` and prints its JSON line; where the reference's script
yields a result (bench.py's candidates, bench_traceback's Match lists,
profile_readset's match counts), the port's equals the JAX package's
XLA engine on the same seeded inputs. Without a card and without
``--device cpu`` each tool exits non-zero before it searches. And the
native FASTX reader, built with g++ into ``build/``, parses as the Python
path does."""

import gzip
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sassy_tpu import Searcher as RefSearcher
from sassy_tpu import profiles as ref_profiles
from sassy_tpu.ops import batch as ref_batch
from sassy_tpu.ops.myers_xla import XlaEngine
from sassy_tpu_torch.io import fastx
from sassy_tpu_torch.ops import batch as port_batch
from sassy_tpu_torch.ops import myers_cuda, myers_torch
from sassy_tpu_torch.tools import (
    bench,
    bench_io_overlap,
    bench_oneshot,
    bench_traceback,
    profile_path,
    profile_readset,
    soak,
)

REPO = Path(__file__).resolve().parent.parent
#: bench.py's keys (bench.py:160-170), which the port's line also carries
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "backend",
              "sequential_gbps", "pipelined_gbps", "n"}


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _key(m):
    return m.sort_key(), m.cigar.to_string()


def test_bench_candidates_equal_the_xla_engine():
    n = 24_000
    rec, cands = bench.run(n, 42, "cpu", seq=2, batches=1, calls=2,
                           log=lambda msg: None)
    text, pattern, ends = bench.make_inputs(n, 42, "cpu")
    ref = ref_profiles.Iupac()
    want = XlaEngine().candidates(ref, ref.encode(pattern), text.numpy(),
                                  bench.K, None, None, False)
    assert cands == sorted(map(tuple, want))
    assert set(ends) <= {e for e, _ in cands}
    assert rec["candidates"] == len(cands)
    # the same seed makes the same text; another seed another
    again, _, _ = bench.make_inputs(n, 42, "cpu")
    other, _, _ = bench.make_inputs(n, 43, "cpu")
    assert torch.equal(text, again) and not torch.equal(text, other)


def test_bench_prints_bench_py_keys_and_spreads(capsys):
    assert bench.main(["--n", "20000", "--device", "cpu"]) == 0
    rec = _last_json(capsys)
    assert BENCH_KEYS <= set(rec)
    assert rec["metric"] == "text_scan_23bp_k3" and rec["unit"] == "GB/s"
    assert rec["backend"] == "cpu" and rec["n"] == 20000
    assert rec["value"] == max(rec["sequential_gbps"],
                               rec["pipelined_gbps"])
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 2.105)
    seq = rec["sequential"]
    assert seq["calls"] == 20
    assert seq["best_ms"] <= seq["p10_ms"] <= seq["median_ms"] <= seq["p90_ms"]
    assert len(rec["pipelined"]["batch_ms"]) == 3
    assert rec["q1meta_ms"]["median_ms"] > 0
    assert rec["calls"] == 1 + 20 + 3 * 8
    assert "card" not in rec


def test_bench_oneshot_runs_every_size(monkeypatch, capsys):
    monkeypatch.setattr(bench_oneshot, "SIZES", (1000, 3000))
    assert bench_oneshot.main(["--device", "cpu", "--reps", "3"]) == 0
    rec = _last_json(capsys)
    assert [r["n"] for r in rec["rows"]] == [1000, 3000]
    assert all(0 < r["p10_ms"] <= r["median_ms"] <= r["p90_ms"]
               for r in rec["rows"])


def test_bench_traceback_matches_equal_the_jax_searcher(capsys):
    rec, matches = bench_traceback.run(30, 0.03, "cpu", log=lambda m: None)
    pattern, text = bench_traceback.make_inputs(30, 0.03)
    want = RefSearcher(ref_profiles.Iupac(), rc=False,
                       engine="xla").search_all(pattern, text, 3)
    assert sorted(map(_key, matches)) == sorted(map(_key, want))
    assert rec["matches"] == len(want) >= 30
    assert bench_traceback.main(["--device", "cpu", "--matches", "10",
                                 "--mb", "0.01"]) == (
        0 if _last_json(capsys)["ok"] else 1)


def test_bench_io_overlap_runs_the_ports_cli(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(bench_io_overlap, "WORKDIR", tmp_path)
    assert bench_io_overlap.main(["--device", "cpu", "--mb", "0.03",
                                  "--guides", "3"]) == 0
    rec = _last_json(capsys)
    assert rec["n"] == 30_000 and rec["batches"] == 1
    assert rec["matches"] == rec["steady_matches"]
    assert rec["e2e_inner"].startswith("Time taken")
    assert rec["serial_s"] >= rec["overlapped_s"] > 0
    assert (tmp_path / "crispr.tsv").read_text().startswith("guide\t")
    # the gzip input parses and searches to the same matches
    monkeypatch.setattr(bench_io_overlap, "WORKDIR", tmp_path / "gz")
    assert bench_io_overlap.main(["--device", "cpu", "--mb", "0.03",
                                  "--guides", "3", "--gzip"]) == 0
    assert _last_json(capsys)["matches"] == rec["matches"]


def test_profile_readset_counts_equal_the_jax_batch_engine(capsys):
    args = dict(Q=3, mb=0.03, read_len=3000, plant_every=700)
    rec = profile_readset.run(**args, device="cpu", log=lambda m: None)
    pats, flat, reads = profile_readset.make_inputs(**args)
    ref = ref_profiles.Iupac()
    eng = ref_batch.BatchEngine(backend="xla")
    codes = [ref.encode(p) for p in pats]
    for label, texts in (("reads", reads), ("flat", [flat])):
        out = eng.candidates_many(ref, codes, texts, 3)
        assert rec[label]["matches"] == sum(len(c) for r in out for c in r)
        assert rec[label]["texts"] == len(texts)
    assert rec["reads"]["matches"] > 0
    assert profile_readset.main(["--device", "cpu", "--q", "2", "--mb",
                                 "0.01", "--read-len", "2000"]) == 0
    assert set(_last_json(capsys)) >= {"reads", "flat", "reads_over_flat"}


def test_profile_path_splits_one_candidates_call():
    """The host split of profile_path: every step of ``calls`` warm
    candidates calls timed, and what the steps leave of the whole call."""
    from sassy_tpu_torch import profiles

    rng = np.random.default_rng(5)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=20_000)
    dna = profiles.Dna()
    codes = dna.encode(text[10_000 : 10_000 + profile_path.PATTERN_LEN])
    eng = myers_torch.TorchEngine("cpu")
    prep = eng.prepare(dna, torch.from_numpy(text))
    split = profile_path.split_call(eng, dna, codes, prep, profile_path.K,
                                    lambda: None, calls=3)
    steps = ("inputs", "scan", "select", "copy", "host", "call")
    assert list(split) == [*steps, "rest"]
    assert all(0 < split[s]["best"] <= split[s]["median"] for s in steps)
    assert split["rest"]["median"] == pytest.approx(
        split["call"]["median"] - sum(split[s]["median"] for s in steps[:-1]))


TOOLS = {"bench": (bench, []), "bench_oneshot": (bench_oneshot, []),
         "bench_traceback": (bench_traceback, []),
         "bench_io_overlap": (bench_io_overlap, []),
         "profile_readset": (profile_readset, []),
         "soak": (soak, ["--workers", "0"])}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_each_tool_exits_non_zero_without_a_card(name, monkeypatch,
                                                 tmp_path, capsys):
    """No card and no ``--device cpu``: the tool says so and exits 2
    before it makes its data or touches the CPU path."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU path ran")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in ("scan_meta_plain", "scan_q_meta_plain", "scan_plain",
               "scan_q_plain"):
        monkeypatch.setattr(myers_cuda, fn, refuse)
    for cls in (port_batch.BatchEngine, myers_torch.TorchEngine):
        monkeypatch.setattr(cls, "__init__", refuse)
    monkeypatch.setattr(bench_io_overlap, "WORKDIR", tmp_path / "io")
    monkeypatch.setattr(soak, "LOG", tmp_path / "log")
    mod, extra = TOOLS[name]
    assert mod.main(extra) == 2
    assert mod.main(["--device", "cuda", *extra]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "io").exists() and not (tmp_path / "log").exists()


def _digests(folder: Path) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.iterdir()) if p.is_file()}


def test_native_fastx_reader_is_built_into_build_and_parses_as_python(
        monkeypatch, tmp_path):
    """With SASSY_NATIVE_FASTX=1 the reader of native/fastxio.cc, built by
    g++ into build/sassy_tpu_torch/ (native/ left as it was), parses FASTA
    (wrapped lines, empty records, CRLF), FASTQ and gzip as the Python
    path does."""
    before = _digests(REPO / "native")
    monkeypatch.setenv("SASSY_NATIVE_FASTX", "1")
    monkeypatch.setattr(fastx, "_NATIVE", None)
    lib = fastx.build_native()
    assert lib.parent == REPO / "build" / "sassy_tpu_torch"
    rng = np.random.default_rng(2)
    seqs = [bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), n))
            for n in (0, 5, 61, 200)]
    fa = b"".join(b">r%d desc\n" % i + b"\n".join(
        s[j : j + 60] for j in range(0, len(s), 60)) + b"\r\n"
        for i, s in enumerate(seqs))
    fq = b"".join(b"@q%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s))
                  for i, s in enumerate(seqs[1:]))
    files = {"a.fa": fa, "b.fq": fq}
    for name, data in list(files.items()):
        (tmp_path / name).write_bytes(data)
        with gzip.open(tmp_path / f"{name}.gz", "wb") as f:
            f.write(data)
        files[f"{name}.gz"] = data
    for name in files:
        path = str(tmp_path / name)
        native = fastx._read_fastx_native(path)
        assert native is not None
        with fastx._open(path) as fh:
            plain = list(fastx.parse_fastx(fh))
        assert [(r.rid, r.seq, r.qual) for r in native] == [
            (r.rid, r.seq, r.qual) for r in plain]
        assert [r.seq for r in list(fastx.read_fastx(path))] == [
            r.seq for r in plain]
    assert _digests(REPO / "native") == before


def test_native_fastx_reader_that_fails_to_build_says_so(monkeypatch,
                                                          tmp_path, capsys):
    """SASSY_NATIVE_FASTX=1 with a build that fails: one line on stderr,
    then the records through the Python path."""
    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setenv("SASSY_NATIVE_FASTX", "1")
    monkeypatch.setattr(fastx, "_NATIVE", None)
    monkeypatch.setattr(fastx, "build_native", broken)
    fa = tmp_path / "a.fa"
    fa.write_bytes(b">r1\nACGT\n>r2\nGG\n")
    assert [(r.rid, r.seq) for r in fastx.read_fastx(str(fa))] == [
        ("r1", b"ACGT"), ("r2", b"GG")]
    assert len(list(fastx.read_fastx(str(fa)))) == 2  # asked once
    assert fastx._NATIVE is False
    err = capsys.readouterr().err
    assert err.count("SASSY_NATIVE_FASTX=1") == 1 and "g++ failed" in err
