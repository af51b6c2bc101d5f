"""The port's ``--resume`` checkpointing and its prefetch reader (the cases
of tests/test_cli_resume.py on ``sassy_tpu_torch.cli``), and a resumed run
of the port byte-identical to the JAX CLI's uninterrupted run.

The kill is injected with SASSY_CRASH_AFTER_UNIT, which dies after unit
N's output is flushed and before its checkpoint is written, the worst
case: the resume truncates the output back to the last checkpoint."""

import json

import numpy as np
import pytest

from sassy_tpu import cli as ref_cli
from sassy_tpu_torch.cli import main
from sassy_tpu_torch.io import fastx
from sassy_tpu_torch.profiles import Iupac

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
RNG = np.random.default_rng(321)


def _dna(n):
    return bytes(RNG.choice(BASES, size=n))


def _write_fasta(path, recs):
    with open(path, "w") as f:
        for rid, seq in recs:
            f.write(f">{rid}\n{seq.decode()}\n")


@pytest.fixture()
def genome(tmp_path):
    pat = _dna(12)
    comp = bytes(Iupac().reverse_complement(pat))
    recs = []
    for i in range(8):
        body = _dna(300)
        if i % 2 == 0:
            body = body[:40] + pat + body[52:]
        if i % 3 == 0:
            body = body[:200] + comp + body[212:]
        recs.append((f"r{i}", body))
    fa = tmp_path / "g.fa"
    _write_fasta(fa, recs)
    return str(fa), pat


def _base(pat, k="2"):
    return ["--device", "cpu", "search", "-p", pat.decode(), "-k", k,
            "--batch-bytes", "400"]


@pytest.mark.parametrize("crash_after", [0, 1, 2])
def test_search_resume_byte_identical(genome, tmp_path, monkeypatch, capsys,
                                      crash_after):
    fa, pat = genome
    base = _base(pat)
    golden = tmp_path / "golden.tsv"
    assert main(base + ["-o", str(golden), fa]) == 0
    golden_err = capsys.readouterr().err

    out = tmp_path / "out.tsv"
    ck = tmp_path / "ck.json"
    monkeypatch.setenv("SASSY_CRASH_AFTER_UNIT", str(crash_after))
    with pytest.raises(SystemExit) as e:
        main(base + ["-o", str(out), "--resume", str(ck), fa])
    assert e.value.code == 130
    capsys.readouterr()
    d = json.loads(ck.read_text()) if crash_after else None
    if crash_after:
        # unit crash_after wrote rows but never checkpointed
        assert d["unit"] == crash_after
    assert out.read_bytes() != golden.read_bytes()

    monkeypatch.delenv("SASSY_CRASH_AFTER_UNIT")
    assert main(base + ["-o", str(out), "--resume", str(ck), fa]) == 0
    # the per-distance histogram covers the whole file
    assert capsys.readouterr().err == golden_err
    assert out.read_bytes() == golden.read_bytes()
    assert json.loads(ck.read_text())["unit"] >= 2


def test_resumed_run_equals_the_jax_cli(genome, tmp_path, monkeypatch,
                                        capsys):
    fa, pat = genome
    flags = ["search", "-p", pat.decode(), "-k", "2", "--batch-bytes", "400"]
    want = tmp_path / "jax.tsv"
    assert ref_cli.main(flags + ["-o", str(want), fa, "--engine", "xla"]) == 0
    want_err = capsys.readouterr().err
    out, ck = tmp_path / "o.tsv", tmp_path / "ck.json"
    monkeypatch.setenv("SASSY_CRASH_AFTER_UNIT", "1")
    with pytest.raises(SystemExit):
        main(["--device", "cpu"] + flags
             + ["-o", str(out), "--resume", str(ck), fa])
    capsys.readouterr()
    monkeypatch.delenv("SASSY_CRASH_AFTER_UNIT")
    assert main(["--device", "cpu"] + flags
                + ["-o", str(out), "--resume", str(ck), fa]) == 0
    assert capsys.readouterr().err == want_err
    assert out.read_bytes() == want.read_bytes()
    assert out.read_text().count("\n") > 4


@pytest.mark.parametrize("crash_after", [0, 2])
def test_resume_killed_inside_a_group(genome, tmp_path, monkeypatch, capsys,
                                      crash_after):
    """Units of two 300 bp records, two a group: killed after the first
    unit of the first or the second group, while the next group is in
    flight. The resumed run dispatches only the units left, and its output
    equals the uninterrupted run's and the JAX CLI's."""
    from sassy_tpu_torch import cli
    from sassy_tpu_torch.search import Searcher

    fa, pat = genome
    pats = tmp_path / "pats.txt"
    rng = np.random.default_rng(17)
    more = [bytes(rng.choice(BASES, size=n)).decode() for n in (12, 14)]
    pats.write_text("\n".join([pat.decode(), *more]) + "\n")
    flags = ["search", "-l", str(pats), "-k", "2", "--batch-bytes", "400",
             "--pattern-batch-size", "2"]
    want = tmp_path / "jax.tsv"
    assert ref_cli.main(flags + ["-o", str(want), fa, "--engine", "xla"]) == 0
    want_err = capsys.readouterr().err
    monkeypatch.setattr(cli, "GROUP_BYTES", 1300)
    whole = tmp_path / "whole.tsv"
    assert main(["--device", "cpu"] + flags + ["-o", str(whole), fa]) == 0
    capsys.readouterr()

    calls = []
    real = Searcher._search_many_batched_async

    def counted(self, pats_, rc_texts, *a, **kw):
        calls.append(len(rc_texts))
        return real(self, pats_, rc_texts, *a, **kw)

    monkeypatch.setattr(Searcher, "_search_many_batched_async", counted)
    out, ck = tmp_path / "o.tsv", tmp_path / "ck.json"
    run = ["--device", "cpu"] + flags + ["-o", str(out), "--resume", str(ck),
                                         fa]
    monkeypatch.setenv("SASSY_CRASH_AFTER_UNIT", str(crash_after))
    with pytest.raises(SystemExit) as e:
        main(run)
    assert e.value.code == 130
    capsys.readouterr()
    if crash_after:
        assert json.loads(ck.read_text())["unit"] == crash_after
    else:
        assert not ck.exists()
    # 4 units in 2 groups of two units, 2 pattern batches: the first
    # group's calls and, in flight, the second's
    assert calls == [4] * 4
    calls.clear()
    monkeypatch.delenv("SASSY_CRASH_AFTER_UNIT")
    assert main(run) == 0
    assert capsys.readouterr().err == want_err
    assert out.read_bytes() == whole.read_bytes() == want.read_bytes()
    assert json.loads(ck.read_text())["unit"] == 4
    # left: all four units (no checkpoint), or units 2-3, one group
    assert calls == [4] * (4 if crash_after == 0 else 2)


def test_resume_rejects_changed_parameters(genome, tmp_path, monkeypatch,
                                           capsys):
    fa, pat = genome
    base = ["--device", "cpu", "search", "-p", pat.decode(),
            "--batch-bytes", "400"]
    out, ck = tmp_path / "o.tsv", tmp_path / "ck.json"
    monkeypatch.setenv("SASSY_CRASH_AFTER_UNIT", "1")
    with pytest.raises(SystemExit):
        main(base + ["-k", "2", "-o", str(out), "--resume", str(ck), fa])
    capsys.readouterr()
    monkeypatch.delenv("SASSY_CRASH_AFTER_UNIT")
    with pytest.raises(SystemExit) as e:
        main(base + ["-k", "1", "-o", str(out), "--resume", str(ck), fa])
    assert "different parameters" in str(e.value.code)
    capsys.readouterr()


def test_resume_requires_file_sink(genome, tmp_path, capsys):
    fa, pat = genome
    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu", "search", "-p", pat.decode(), "-k", "1",
              "--resume", str(tmp_path / "nope.json"), fa])
    assert "requires TSV output to a file" in str(e.value.code)
    capsys.readouterr()


@pytest.mark.parametrize("pam_edits", [False, True])
def test_crispr_resume_byte_identical(tmp_path, monkeypatch, capsys,
                                      pam_edits):
    guide = _dna(20) + b"AGG"
    recs = []
    for i in range(6):
        body = _dna(500)
        if i % 2 == 0:
            body = body[:100] + guide + body[123:]
        if i % 3 == 1:
            body = body[:300] + guide[:20] + b"ACA" + body[323:]
        recs.append((f"c{i}", body))
    fa = tmp_path / "g.fa"
    _write_fasta(fa, recs)
    gf = tmp_path / "guides.txt"
    gf.write_text(guide.decode() + "\n")

    flags = ["crispr", "-g", str(gf), "-k", "2", "--max-n-frac", "0.2",
             "--batch-bytes", "600"] + (["--allow-pam-edits"] * pam_edits)
    golden = tmp_path / "golden.tsv"
    assert ref_cli.main(flags + ["--engine", "xla", "-o", str(golden),
                                 str(fa)]) == 0
    capsys.readouterr()

    out, ck = tmp_path / "out.tsv", tmp_path / "ck.json"
    monkeypatch.setenv("SASSY_CRASH_AFTER_UNIT", "1")
    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu"] + flags
             + ["-o", str(out), "--resume", str(ck), str(fa)])
    assert e.value.code == 130
    capsys.readouterr()
    monkeypatch.delenv("SASSY_CRASH_AFTER_UNIT")
    assert main(["--device", "cpu"] + flags
                + ["-o", str(out), "--resume", str(ck), str(fa)]) == 0
    capsys.readouterr()
    assert out.read_bytes() == golden.read_bytes()
    assert out.read_text().count("\n") >= 4


def test_prefetch_order_and_exhaustion():
    assert list(fastx.prefetch(iter(range(100)), depth=3)) == list(range(100))
    assert list(fastx.prefetch(iter(()))) == []


def test_prefetch_propagates_exception():
    def gen():
        yield 1
        raise ValueError("boom")

    it = fastx.prefetch(gen())
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)


def test_prefetch_early_abandon():
    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    for i, x in enumerate(fastx.prefetch(gen(), depth=2)):
        if i == 3:
            break
    assert len(produced) < 10_000
