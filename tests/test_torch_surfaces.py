"""The port's surfaces against the JAX package's on the same seeded inputs:
the fastx parsers and batching, the pretty printer, GenomeScan's output
files (over segment boundaries, and resumed), and the diagnostics (the H100
bound of ``cost_model``, the profiler trace, ``self_test`` on the CPU)."""

import gzip
import importlib.util
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest

from sassy_tpu import Searcher as RefSearcher
from sassy_tpu import pretty_print as ref_pp
from sassy_tpu import profiles as ref_profiles
from sassy_tpu.io import fastx as ref_fastx
from sassy_tpu.scan import GenomeScan as RefGenomeScan
from sassy_tpu_torch import Searcher, diagnostics, pretty_print as pp
from sassy_tpu_torch.io import fastx
from sassy_tpu_torch.ops.myers_torch import TorchEngine
from sassy_tpu_torch.scan import GenomeScan, ScanProgress

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

FA = b">r1 desc here\nACGT\nACGT\n>r2\nTTTT\n>empty\n>r3\nA\n>r4\r\nAC\r\nGT\r\n"
FQ = b"@q1\nACGTA\n+\nIIIII\n@q2 x\nGG\n+\n##\n@q3\n\n+\n\n"


def _recs(recs):
    return [(r.rid, r.seq, r.qual) for r in recs]


def _random_fasta(seed, n_recs):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_recs):
        seq = bytes(rng.choice(BASES, int(rng.integers(0, 400))))
        wrapped = b"\n".join(seq[j : j + 60] for j in range(0, len(seq), 60))
        out.append(b">rec%d some description\n" % i + wrapped + b"\n")
    return b"".join(out)


@pytest.mark.parametrize("name,data", [
    ("t.fa", FA), ("t.fq", FQ), ("t.fa.gz", FA), ("t.fq.gz", FQ),
    ("big.fa", _random_fasta(5, 40)), ("big.fa.gz", _random_fasta(6, 40)),
])
def test_parsers_equal_the_reference(tmp_path, name, data):
    p = tmp_path / name
    p.write_bytes(gzip.compress(data) if name.endswith(".gz") else data)
    got = _recs(fastx.read_fastx(str(p)))
    assert got == _recs(ref_fastx.read_fastx(str(p)))
    assert got and got == _recs(fastx.parse_fastx(
        io.BufferedReader(io.BytesIO(data))))


@pytest.mark.parametrize("gz", [False, True])
def test_stdin_equals_the_reference(monkeypatch, gz):
    data = gzip.compress(FQ) if gz else FQ

    def stdin():
        monkeypatch.setattr("sys.stdin", io.TextIOWrapper(
            io.BufferedReader(io.BytesIO(data))))

    stdin()
    got = _recs(fastx.read_fastx("-"))
    stdin()
    assert got == _recs(ref_fastx.read_fastx("")) and len(got) == 3


def test_write_record_equals_the_reference():
    recs = list(fastx.parse_fastx(io.BufferedReader(io.BytesIO(FQ + FA[:0]))))
    recs += list(fastx.parse_fastx(io.BufferedReader(io.BytesIO(FA))))
    ref = list(ref_fastx.parse_fastx(io.BufferedReader(io.BytesIO(FQ))))
    ref += list(ref_fastx.parse_fastx(io.BufferedReader(io.BytesIO(FA))))
    got_b, want_b = io.BytesIO(), io.BytesIO()
    got_t, want_t = io.StringIO(), io.StringIO()
    for r, w in zip(recs, ref):
        fastx.write_record(got_b, r)
        ref_fastx.write_record(want_b, w)
        fastx.write_record_text(got_t, r)
        ref_fastx.write_record_text(want_t, w)
    assert got_b.getvalue() == want_b.getvalue()
    assert got_t.getvalue() == want_t.getvalue()


@pytest.mark.parametrize("batch_bytes,batch_patterns,rc", [
    (1 << 20, 64, True), (500, 2, True), (1, 3, False), (2000, 1, False),
])
def test_iter_batches_equal_the_reference(tmp_path, batch_bytes,
                                          batch_patterns, rc):
    a, b = tmp_path / "a.fa", tmp_path / "b.fa.gz"
    a.write_bytes(_random_fasta(7, 25))
    b.write_bytes(gzip.compress(_random_fasta(8, 9)))
    ids = [f"p{i}" for i in range(5)]
    pats = [b"ACGT" * (i + 2) for i in range(5)]

    def items(mod):
        return [(w.path, w.batch_id, w.pattern_ids, w.patterns,
                 w.pattern_offset, _recs(w.records), w.record_offset,
                 [(r.cached.text().tobytes(), r.cached.rev_text().tobytes())
                  for r in w.records])
                for w in mod.iter_batches([str(a), str(b)], ids, pats,
                                          batch_bytes, batch_patterns, rc)]

    got = items(fastx)
    assert got == items(ref_fastx) and len(got) > 1


def _matches(seed):
    """The same search on both packages: forward and reverse matches with
    substitutions, indels and overhang, over a text with line breaks."""
    rng = np.random.default_rng(seed)
    pat = bytes(rng.choice(BASES, 24))
    iupac = ref_profiles.Iupac()
    mut = bytearray(pat)
    mut[5] = ord("A") if mut[5] != ord("A") else ord("C")
    del mut[15]
    text = (pat[7:] + bytes(rng.choice(BASES, 60)) + b"\n"
            + bytes(iupac.reverse_complement(bytes(mut)))
            + bytes(rng.choice(BASES, 30)) + b"\n" + bytes(mut)
            + bytes(rng.choice(BASES, 45)) + pat[:20])
    got = Searcher("iupac", rc=True, alpha=0.5, device="cpu").search(
        pat, text, 4)
    want = RefSearcher(iupac, rc=True, alpha=0.5, engine="xla").search(
        pat, text, 4)
    assert [(m.sort_key(), m.cigar.to_string()) for m in got] == [
        (m.sort_key(), m.cigar.to_string()) for m in want]
    return pat, text, got, want


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("direction", ["text", "pattern"])
@pytest.mark.parametrize("style", ["full", "compact", "line"])
def test_pretty_print_equals_the_reference(seed, direction, style):
    pat, text, got, want = _matches(seed)
    strands = {str(m.strand) for m in got}
    assert strands == {"+", "-"} and any(
        m.pattern_start > 0 or m.pattern_end < len(pat) for m in got)
    for ctx in (0, 5, 20):
        for color in (True, False):
            for pid in ("p", None):
                for g, w in zip(got, want):
                    assert pp.pretty_print(
                        g, pid, pat, text, direction, ctx, style, color
                    ) == ref_pp.pretty_print(
                        w, pid, pat, text, direction, ctx, style, color)


def test_pretty_print_match_equals_the_reference():
    pat, text, got, want = _matches(2)
    for g, w in zip(got, want):
        seg = np.frombuffer(text, np.uint8)[g.text_start : g.text_end]
        for color in (True, False):
            assert pp.pretty_print_match(
                np.frombuffer(pat, np.uint8)[g.pattern_start : g.pattern_end],
                seg, g.cigar, color) == ref_pp.pretty_print_match(
                np.frombuffer(pat, np.uint8)[w.pattern_start : w.pattern_end],
                seg, w.cigar, color)


def _genome(tmp_path, seed):
    rng = np.random.default_rng(seed)
    pats = [bytes(rng.choice(BASES, 20)), bytes(rng.choice(BASES, 20))]
    rc = ref_profiles.Iupac().reverse_complement
    big = bytearray(rng.choice(BASES, 9000))
    # 2988 and 5990 straddle the 3000 / 6000 segment boundaries
    for off, seq in ((100, pats[0]), (2988, pats[0]), (5990, rc(pats[1])),
                     (6500, pats[1]), (8980, rc(pats[0]))):
        big[off : off + 20] = seq
    small = bytes(rng.choice(BASES, 300)) + pats[1]
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        for rid, seq in (("chr1", bytes(big)), ("chr2", small),
                         ("chr3", bytes(rng.choice(BASES, 3500)))):
            f.write(f">{rid}\n{seq.decode()}\n")
    return str(fa), pats


@pytest.mark.parametrize("n_pats,k", [(1, 0), (1, 2), (2, 1)])
def test_genome_scan_equals_the_reference(tmp_path, n_pats, k):
    fa, pats = _genome(tmp_path, 3)
    pats = pats[:n_pats]
    got_out, want_out = tmp_path / "got.tsv", tmp_path / "want.tsv"
    got = GenomeScan(Searcher("iupac", rc=True, device="cpu"),
                     segment_chars=3000,
                     checkpoint=str(tmp_path / "got.json")).scan(
        fa, pats, k, str(got_out))
    want = RefGenomeScan(RefSearcher(ref_profiles.Iupac(), rc=True,
                                     engine="xla"),
                         segment_chars=3000,
                         checkpoint=str(tmp_path / "want.json")).scan(
        fa, pats, k, str(want_out))
    assert got == want and got >= 3 * n_pats
    assert got_out.read_bytes() == want_out.read_bytes()
    assert json.loads((tmp_path / "got.json").read_text()) == json.loads(
        (tmp_path / "want.json").read_text())
    # the rows equal a whole-record search
    if n_pats == 1:
        s = Searcher("iupac", rc=True, device="cpu")
        rows = {tuple(r.split("\t")) for r in
                got_out.read_text().splitlines()[1:]}
        whole = set()
        for rec in fastx.read_fastx(fa):
            for m in s.search(pats[0], rec.seq, k):
                whole.add(("0", rec.rid, str(m.cost), str(m.strand),
                           str(m.text_start), str(m.text_end)))
        assert rows == whole


@pytest.mark.parametrize("done", [1, 2, 4])
def test_genome_scan_resumed_equals_uninterrupted(tmp_path, done,
                                                  monkeypatch):
    """A scan killed after ``done`` units (its last unit's rows written, its
    checkpoint not) and resumed writes the same file as one that ran
    through."""
    fa, pats = _genome(tmp_path, 4)
    s = Searcher("iupac", rc=True, device="cpu")
    full = tmp_path / "full.tsv"
    GenomeScan(s, 3000, str(tmp_path / "full.json")).scan(fa, pats[:1], 1,
                                                          str(full))
    out, ck = tmp_path / "out.tsv", tmp_path / "ck.json"
    saves = []
    save = ScanProgress.save

    def dying_save(self):
        if len(saves) == done:
            raise KeyboardInterrupt
        saves.append(self.unit)
        save(self)

    monkeypatch.setattr(ScanProgress, "save", dying_save)
    with pytest.raises(KeyboardInterrupt):
        GenomeScan(s, 3000, str(ck)).scan(fa, pats[:1], 1, str(out))
    monkeypatch.setattr(ScanProgress, "save", save)
    assert json.loads(ck.read_text())["unit"] == done
    total = GenomeScan(s, 3000, str(ck)).scan(fa, pats[:1], 1, str(out))
    assert out.read_bytes() == full.read_bytes()
    assert total == len(full.read_text().splitlines()) - 1


def test_cost_model_is_the_kernels_bound():
    """``chip_smoke.py`` reports the bound that ``diagnostics`` computes;
    on phase 2's shape (1 GiB, 23 bp, k=3, pure eq) it is 1.254 ms, as
    before it moved, and the windows are the ones the engine builds."""
    assert chip_smoke.bound is diagnostics.scan_bound
    got = diagnostics.cost_model(23, 1 << 30, 3)
    assert got["windows"] == (65, 4, 532611) and got["rows"] == 24
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(1.2542295164, rel=1e-9)
    assert got["bound_ms"] == chip_smoke.bound("pure", 1, 24, got["windows"],
                                               True)["bound_ms"]
    # q2meta at phase 6's chunk
    assert diagnostics.scan_bound("pure", 96, 24, (321, 4, 8710), True)[
        "bound_ms"] == pytest.approx(9.724067, rel=1e-6)
    # the windows are the engine's, for several sizes and profiles
    rng = np.random.default_rng(9)
    eng = TorchEngine("cpu")
    for n, m, k, name in ((70_000, 23, 3, "dna"), (9_000, 100, 5, "iupac"),
                          (40_000, 30, 2, "ascii")):
        text = rng.choice(BASES, n)
        from sassy_tpu_torch import profiles

        prof = profiles.get_profile(name)
        inp = eng.build_inputs(prof, prof.encode(text[:m]), text, k)
        got = diagnostics.cost_model(m, n, k, 1, inp.eq_mode)
        assert got["windows"] == tuple(inp.windows.shape)
        assert got["rows"] == inp.pmasks.shape[0]
        want = diagnostics.scan_bound(inp.eq_mode, 1, inp.pmasks.shape[0],
                                      tuple(inp.windows.shape), True)
        assert got["bound_ms"] == want["bound_ms"]
        assert got["sol_gbps"] == pytest.approx(
            n / (want["bound_ms"] / 1e3) / 1e9)
    assert diagnostics.cost_model(24, 10_000, 3, 96)["dp_cells"] == (
        10_000 * 24 * 96)


def test_trace_writes_a_chrome_trace(tmp_path):
    text = np.random.default_rng(1).choice(BASES, 3000)
    with diagnostics.trace(str(tmp_path / "tr")) as prof:
        Searcher("dna", device="cpu").search(text[100:123], text, 1)
    path = tmp_path / "tr" / "trace.json"
    assert path.exists() and os.path.getsize(path) > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert events and prof.key_averages()


def test_self_test_on_the_cpu():
    info = diagnostics.self_test(5000, verbose=False, device="cpu")
    assert {"torch", "cuda", "cuda_available", "nvcc", "device_count",
            "device", "engine", "search_device",
            "throughput_gbps"} <= set(info)
    assert info["engine"] == "plain PyTorch"
    assert info["search_device"] == "cpu" and info["throughput_gbps"] > 0


def test_self_test_asks_for_the_card_by_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diagnostics.self_test(5000, verbose=False)
