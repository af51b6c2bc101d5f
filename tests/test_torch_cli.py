"""The port's command line against the JAX package's, byte for byte.

Every case runs ``sassy_tpu.cli.main([..., "--engine", "xla"])`` and
``sassy_tpu_torch.cli.main(["--device", "cpu", ...])`` on the same seeded
files (reads of 60-300 bp with planted copies) and compares stdout and
stderr. The only text allowed to differ is crispr's ``Time taken`` line.
search / grep / filter group their units into one batched call a pattern
batch: the same bytes over several groups (``cli.GROUP_BYTES`` made
small), exactly groups x pattern batches calls of
``Searcher._search_many_batched_async``, and one upload of a group's
records for all its pattern batches (one text set a group).
Also: ``--device cuda`` without a card exits non-zero, ``SASSY_DEVICE``
sets the device, ``test`` prints the port's features, and a closed stdout
ends the run quietly with 141."""

import gzip
import io
import re
import sys

import numpy as np
import pytest
import torch

from sassy_tpu import cli as ref_cli
from sassy_tpu_torch import cli
from sassy_tpu_torch.profiles import Iupac

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _write_fasta(path, recs):
    with open(path, "w") as f:
        for rid, seq in recs:
            f.write(f">{rid}\n{seq.decode()}\n")


def _fastq_text(recs) -> str:
    return "".join(f"@{rid}\n{seq.decode()}\n+\n{'I' * len(seq)}\n"
                   for rid, seq in recs)


def _mutate(rng, seq: bytes, edits: int) -> bytes:
    s = bytearray(seq)
    for _ in range(edits):
        i = int(rng.integers(0, len(s)))
        what = int(rng.integers(0, 3))
        if what == 0:
            s[i] = BASES[(list(BASES).index(s[i]) + 1) % 4]
        elif what == 1:
            del s[i]
        else:
            s.insert(i, BASES[int(rng.integers(0, 4))])
    return bytes(s)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Reads of 60-300 bp: copies of three 25 bp patterns planted exact,
    with edits, reverse-complemented, hanging off either end, and one read
    with a run of N; the same reads as FASTA, gzipped FASTA and FASTQ; the
    patterns as a line file and as FASTA; a guide file and a genome for
    crispr; a text for agrep."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(2024)
    dna = lambda n: bytes(rng.choice(BASES, size=n))  # noqa: E731
    pats = [dna(25), dna(25), dna(22)]
    iupac = Iupac()
    recs = []
    for i in range(24):
        n = int(rng.integers(60, 301))
        body = bytearray(dna(n))
        p = pats[i % 3]
        kind = i % 6
        if kind == 0:
            ins = p
        elif kind == 1:
            ins = _mutate(rng, p, 1)
        elif kind == 2:
            ins = bytes(iupac.reverse_complement(_mutate(rng, p, 2)))
        elif kind == 3:
            ins = None
        else:
            ins = p if kind == 4 else bytes(iupac.reverse_complement(p))
        if ins is not None and kind < 4:
            at = int(rng.integers(0, n - len(ins)))
            body[at : at + len(ins)] = ins
        elif kind == 4:  # hangs 6 chars off the read's start
            body[: len(p) - 6] = p[6:]
        elif kind == 5:  # hangs 5 chars off the read's end
            body[n - (len(p) - 5) :] = ins[: len(p) - 5]
        if i == 9:
            body[30:45] = b"N" * 15
            body[50 : 50 + len(p)] = p
        recs.append((f"read{i}", bytes(body)))
    fa = d / "reads.fa"
    _write_fasta(fa, recs)
    with gzip.open(d / "reads.fa.gz", "wt") as f:
        f.write(fa.read_text())
    (d / "reads.fq").write_text(_fastq_text(recs))
    (d / "pats.txt").write_text("".join(p.decode() + "\n" for p in pats))
    _write_fasta(d / "pats.fa", [(f"p{i}", p) for i, p in enumerate(pats)])

    guide20 = dna(20)
    guide = guide20 + b"AGG"
    other = dna(20) + b"AGG"
    genome = (dna(400) + guide + dna(200) + guide20 + b"TCA" + dna(300)
              + bytes(iupac.reverse_complement(_mutate(rng, guide, 1)))
              + dna(150) + other + dna(90))
    _write_fasta(d / "genome.fa",
                 [("chr1", genome), ("chr2", dna(250) + other)])
    (d / "guides.txt").write_text(f"{guide.decode()}\n{other.decode()}\n")
    # N runs at the contigs' ends and inside them, some over a guide's
    # copy, with PAM sites on both strands
    rc = iupac.reverse_complement
    n_run = lambda n: b"N" * n  # noqa: E731
    _write_fasta(d / "genome_n.fa", [
        ("chrN1", n_run(12) + guide + dna(60) + n_run(40) + dna(30)
         + guide20[:14] + n_run(6) + b"TGG" + dna(50)
         + bytes(rc(_mutate(rng, guide, 1))) + n_run(25)),
        ("chrN2", bytes(rc(guide)) + dna(40) + n_run(30) + other[:20]
         + b"CGG" + n_run(18) + bytes(rc(other))[:17] + n_run(6)),
        ("chrN3", n_run(5) + bytes(rc(guide20 + b"TCA")) + dna(30)
         + _mutate(rng, other, 1) + n_run(9)),
    ])
    # a guide shorter than --pam-length 26 (so its whole self is the PAM,
    # checked at the start of the last 26 bytes), periodic so that runs of
    # its period pass, with a copy at a contig's start that cannot
    short = (b"ACG" * 8)[:23]
    (d / "guide_short.txt").write_text(short.decode() + "\n")
    _write_fasta(d / "genome_short.fa", [
        ("chrS1", short + dna(40) + b"ACG" * 14 + dna(30)
         + bytes(rc(b"ACG" * 14)) + dna(20)),
        ("chrS2", dna(20) + b"ACG" * 10 + dna(15)),
    ])

    lines = [b"hello world", b"nothing here", b"healo world again",
             b"HELLO WORLD", b"hello  world, twice hello world"]
    (d / "lines.txt").write_bytes(b"\n".join(lines) + b"\n")
    (d / "more.txt").write_bytes(b"say hallo world\n")
    return d, pats


P0 = "{p0}"

#: units of 700 bytes (2-6 reads) and batches of two of the three
#: patterns, all in one group at the CLI's GROUP_BYTES
GROUPED = ["--batch-bytes", "700", "--pattern-batch-size", "2"]

#: name -> (argv after the subcommand's place; {d} the files' directory,
#: {p0} the first pattern), stdin file or None. The JAX CLI gets
#: "--engine xla" appended.
CASES = {
    "search": (["search", "-p", P0, "-k", "1", "{d}/reads.fa"], None),
    "search_k3": (["search", "-p", P0, "-k", "3", "{d}/reads.fa"], None),
    "search_sam": (["search", "-p", P0, "-k", "2", "--sam", "{d}/reads.fa"],
                   None),
    "search_no_rc": (["search", "-p", P0, "-k", "2", "--no-rc",
                      "{d}/reads.fa"], None),
    "search_pattern_file": (["search", "-l", "{d}/pats.txt", "-k", "2",
                             "{d}/reads.fa"], None),
    "search_pattern_file_k0": (["search", "-l", "{d}/pats.txt", "-k", "0",
                                "--no-rc", "{d}/reads.fa"], None),
    "search_pattern_fasta": (["search", "-f", "{d}/pats.fa", "-k", "2",
                              "{d}/reads.fa"], None),
    "search_pattern_batches": (["search", "-f", "{d}/pats.fa", "-k", "2",
                                "--pattern-batch-size", "2",
                                "--batch-bytes", "700", "{d}/reads.fa"],
                               None),
    "search_dna": (["search", "-a", "dna", "-p", P0, "-k", "2",
                    "{d}/reads.fa"], None),
    "search_max_n_frac": (["search", "-f", "{d}/pats.fa", "-k", "3",
                           "--max-n-frac", "0.0", "{d}/reads.fa"], None),
    "search_overhang": (["search", "-f", "{d}/pats.fa", "-k", "3",
                         "--overhang", "0.5", "{d}/reads.fa"], None),
    "search_overhang_sam": (["search", "-p", P0, "-k", "4", "--overhang",
                             "0.5", "--sam", "{d}/reads.fa"], None),
    "search_v2": (["search", "-l", "{d}/pats.txt", "-k", "2", "--v2",
                   "{d}/reads.fa"], None),
    "search_gz": (["search", "-p", P0, "-k", "2", "{d}/reads.fa.gz"], None),
    "search_fastq": (["search", "-p", P0, "-k", "2", "{d}/reads.fq"], None),
    "search_stdin": (["search", "-p", P0, "-k", "2"], "reads.fa"),
    "search_two_files": (["search", "-p", P0, "-k", "2", "{d}/reads.fa",
                          "{d}/reads.fq"], None),
    "search_with_filter": (["search", "-p", P0, "-k", "1", "--filter", "-",
                            "{d}/reads.fa"], None),
    "grep": (["grep", "-f", "{d}/pats.fa", "-k", "2", "{d}/reads.fa"], None),
    "grep_overhang": (["grep", "-p", P0, "-k", "3", "--overhang", "0.5",
                       "{d}/reads.fa"], None),
    "grep_search_tsv": (["grep", "-p", P0, "-k", "1", "--search", "-",
                         "{d}/reads.fa"], None),
    "grep_stdin": (["grep", "-p", P0, "-k", "1"], "reads.fa"),
    "grep_invert_warning": (["grep", "-p", P0, "-k", "1", "-v",
                             "{d}/reads.fa"], None),
    "filter": (["filter", "-p", P0, "-k", "1", "{d}/reads.fa"], None),
    "filter_invert": (["filter", "-p", P0, "-k", "1", "-v", "{d}/reads.fa"],
                      None),
    "filter_fastq": (["filter", "-l", "{d}/pats.txt", "-k", "2",
                      "{d}/reads.fq"], None),
    "filter_search_tsv": (["filter", "-p", P0, "-k", "2", "--search", "-",
                           "{d}/reads.fa"], None),
    "crispr": (["crispr", "-g", "{d}/guides.txt", "-k", "1", "--max-n-frac",
                "0.2", "{d}/genome.fa"], None),
    "crispr_pam_edits": (["crispr", "-g", "{d}/guides.txt", "-k", "1",
                          "--allow-pam-edits", "--max-n-frac", "0.2",
                          "{d}/genome.fa"], None),
    "crispr_no_rc_batches": (["crispr", "-g", "{d}/guides.txt", "-k", "2",
                              "--no-rc", "--max-n-frac", "0.2",
                              "--batch-bytes", "300", "{d}/genome.fa"],
                             None),
    "crispr_n_runs": (["crispr", "-g", "{d}/guides.txt", "-k", "2",
                       "--max-n-frac", "0.2", "{d}/genome_n.fa"], None),
    "crispr_n_runs_pam_edits": (["crispr", "-g", "{d}/guides.txt", "-k",
                                 "1", "--allow-pam-edits", "--max-n-frac",
                                 "0.3", "{d}/genome_n.fa"], None),
    "crispr_guide_shorter_than_pam": (["crispr", "-g",
                                       "{d}/guide_short.txt", "-k", "1",
                                       "--pam-length", "26", "--max-n-frac",
                                       "0.2",
                                       "{d}/genome_short.fa"], None),
    # several units and pattern batches in one grouped call
    "search_grouped_filter": (["search", "-f", "{d}/pats.fa", "-k", "3",
                               "--filter", "-", *GROUPED, "{d}/reads.fa"],
                              None),
    "search_grouped_v2": (["search", "-l", "{d}/pats.txt", "-k", "2", "--v2",
                           *GROUPED, "{d}/reads.fa"], None),
    "search_grouped_overhang": (["search", "-f", "{d}/pats.fa", "-k", "3",
                                 "--overhang", "0.5", *GROUPED,
                                 "{d}/reads.fa"], None),
    "search_grouped_max_n_frac": (["search", "-f", "{d}/pats.fa", "-k", "3",
                                   "--max-n-frac", "0.0", *GROUPED,
                                   "{d}/reads.fq"], None),
    "grep_grouped": (["grep", "-f", "{d}/pats.fa", "-k", "2", "--search", "-",
                      *GROUPED, "{d}/reads.fa"], None),
    "filter_grouped_invert": (["filter", "-v", "-f", "{d}/pats.fa", "-k", "2",
                               *GROUPED, "{d}/reads.fa"], None),
    "agrep": (["agrep", "hello world", "1", "{d}/lines.txt"], None),
    "agrep_context": (["agrep", "hello world", "2", "-C", "3",
                       "{d}/lines.txt", "{d}/more.txt"], None),
    "agrep_stdin": (["agrep", "hello world", "1"], "lines.txt"),
}

_TIME = re.compile(r"Time taken: [0-9.]+s")


def _argv(argv, d, pats):
    return [a.format(d=d, p0=pats[0].decode()) for a in argv]


def _run(main, argv, capsys, monkeypatch, stdin_path):
    if stdin_path is not None:
        data = stdin_path.read_bytes()
        monkeypatch.setattr(sys, "stdin",
                            io.TextIOWrapper(io.BytesIO(data)))
    rc = main(argv)
    got = capsys.readouterr()
    return rc, _TIME.sub("Time taken: -", got.out), got.err


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_equals_the_jax_cli(case, files, capsys, monkeypatch):
    d, pats = files
    argv, stdin = CASES[case]
    argv = _argv(argv, d, pats)
    stdin_path = d / stdin if stdin else None
    want = _run(ref_cli.main, argv + ["--engine", "xla"], capsys,
                monkeypatch, stdin_path)
    got = _run(cli.main, ["--device", "cpu"] + argv, capsys, monkeypatch,
               stdin_path)
    assert got == want
    assert got[0] == 0
    if case.startswith(("search", "crispr")):
        assert got[1].count("\n") > 3, "the case should report matches"


def _unit_bytes(path, batch_bytes: int) -> list[int]:
    """The record bytes of each unit of ``path`` (records until they hold
    ``batch_bytes``), from the file's own lines."""
    units, size = [], 0
    for line in path.read_text().splitlines():
        if not line.startswith(">"):
            size += len(line)
            if size >= batch_bytes:
                units.append(size)
                size = 0
    return units + [size] * bool(size)


def _n_groups(units: list[int], group_bytes: int) -> int:
    n, size = 0, None
    for u in units:
        if size is None or size + u > group_bytes:
            n, size = n + 1, 0
        size += u
    return n


#: group bytes that put each unit of 700 bytes in a group of its own, one
#: or two in one, and all in one
GROUP_SIZES = (1, 1_500, 32 << 20)


@pytest.mark.parametrize("group_bytes", GROUP_SIZES[:2])
@pytest.mark.parametrize("case", ["search_grouped_filter",
                                  "search_grouped_v2", "grep_grouped"])
def test_several_groups_equal_the_jax_cli(case, group_bytes, files, capsys,
                                          monkeypatch):
    d, pats = files
    argv = _argv(CASES[case][0], d, pats)
    want = _run(ref_cli.main, argv + ["--engine", "xla"], capsys,
                monkeypatch, None)
    monkeypatch.setattr(cli, "GROUP_BYTES", group_bytes)
    got = _run(cli.main, ["--device", "cpu"] + argv, capsys, monkeypatch,
               None)
    assert got == want and got[0] == 0


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("group_bytes", GROUP_SIZES)
def test_one_batched_call_a_group_and_pattern_batch(group_bytes, v2, files,
                                                    capsys, monkeypatch):
    """A run makes exactly groups x pattern batches batched calls, each
    over all of its group's records."""
    from sassy_tpu_torch.search import Searcher

    d, pats = files
    calls = []
    real = Searcher._search_many_batched_async

    def counted(self, pats_, rc_texts, *a, **kw):
        calls.append(len(rc_texts))
        return real(self, pats_, rc_texts, *a, **kw)

    monkeypatch.setattr(Searcher, "_search_many_batched_async", counted)
    monkeypatch.setattr(cli, "GROUP_BYTES", group_bytes)
    assert cli.main(["--device", "cpu", "search", "-f", f"{d}/pats.fa",
                     "-k", "2", *GROUPED, *(["--v2"] * v2),
                     f"{d}/reads.fa"]) == 0
    capsys.readouterr()
    units = _unit_bytes(d / "reads.fa", 700)
    groups = _n_groups(units, group_bytes)
    assert len(units) > 3
    assert groups == {1: len(units), 32 << 20: 1}.get(group_bytes, groups)
    assert 1 < groups < len(units) or group_bytes in (1, 32 << 20)
    assert len(calls) == groups * 2  # three patterns in batches of two
    assert sum(calls) == 2 * 24  # every read once a pattern batch


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("group_bytes", GROUP_SIZES)
def test_a_group_uploads_its_records_once(group_bytes, v2, files, capsys,
                                          monkeypatch):
    """The pattern batches of a group share one text set: one upload of
    its records (``_upload_set``) a group, while the calls stay groups x
    pattern batches and stdout and stderr stay the JAX CLI's."""
    from sassy_tpu_torch.ops import batch
    from sassy_tpu_torch.search import Searcher

    d, pats = files
    argv = ["search", "-f", f"{d}/pats.fa", "-k", "2", *GROUPED,
            *(["--v2"] * v2), f"{d}/reads.fa"]
    want = _run(ref_cli.main, argv + ["--engine", "xla"], capsys,
                monkeypatch, None)
    uploads, calls = [], []
    real_upload = batch._upload_set
    real_call = Searcher._search_many_batched_async

    def upload(texts, device):
        uploads.append(len(texts))
        return real_upload(texts, device)

    def call(self, *a, **kw):
        calls.append(kw.get("textset"))
        return real_call(self, *a, **kw)

    monkeypatch.setattr(batch, "_upload_set", upload)
    monkeypatch.setattr(Searcher, "_search_many_batched_async", call)
    monkeypatch.setattr(cli, "GROUP_BYTES", group_bytes)
    got = _run(cli.main, ["--device", "cpu"] + argv, capsys, monkeypatch,
               None)
    assert got == want and got[0] == 0
    groups = _n_groups(_unit_bytes(d / "reads.fa", 700), group_bytes)
    assert len(uploads) == groups and sum(uploads) == 24
    assert len(calls) == groups * 2
    assert len({id(ts) for ts in calls}) == groups
    assert all(a is b for a, b in zip(calls[::2], calls[1::2]))


def test_device_cuda_without_a_card_exits_non_zero(files, monkeypatch,
                                                     capsys):
    d, pats = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["search", "-p", pats[0].decode(), "-k", "1", f"{d}/reads.fa"]
    for pre in (["--device", "cuda"], []):
        monkeypatch.delenv("SASSY_DEVICE", raising=False)
        with pytest.raises(SystemExit) as e:
            cli.main(pre + argv)
        assert e.value.code not in (0, None)
        assert "no CUDA device" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_sassy_device_sets_the_device(files, monkeypatch, capsys):
    d, pats = files
    argv = ["search", "-p", pats[0].decode(), "-k", "1", f"{d}/reads.fa"]
    monkeypatch.setenv("SASSY_DEVICE", "cpu")
    assert cli.main(argv) == 0
    from_env = capsys.readouterr()
    assert cli.main(["--device", "cpu"] + argv) == 0
    assert capsys.readouterr() == from_env
    monkeypatch.setenv("SASSY_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        cli.main(argv)


def test_test_prints_the_ports_features(capsys, monkeypatch):
    from sassy_tpu_torch import diagnostics

    real = diagnostics.self_test
    monkeypatch.setattr(diagnostics, "self_test",
                        lambda text_bytes, verbose, device:
                        real(2000, verbose, device))
    assert cli.main(["--device", "cpu", "test"]) == 0
    out = capsys.readouterr().out
    for key in ("torch:", "cuda_available:", "nvcc:", "engine:",
                "search_device:", "throughput:"):
        assert key in out
    assert "plain PyTorch" in out and "GB/s" in out


def test_closed_stdout_exits_quietly_with_141(files, monkeypatch):
    d, pats = files
    closed = io.StringIO()
    closed.close()
    monkeypatch.setattr(sys, "stdout", closed)
    assert cli.main(["--device", "cpu", "search", "-p", pats[0].decode(),
                     "-k", "1", f"{d}/reads.fa"]) == 141


def test_other_value_errors_are_raised(files):
    d, pats = files
    with pytest.raises(ValueError, match="not supported"):
        cli.main(["--device", "cpu", "search", "-a", "dna", "--overhang",
                  "0.5", "-p", pats[0].decode(), "-k", "1", f"{d}/reads.fa"])
