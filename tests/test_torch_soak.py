"""The port's differential soak (``sassy_tpu_torch.tools.soak``) on the CPU.

Its groups and cases are byte for byte those of the reference's
``scripts/soak_batch.py`` / ``scripts/soak_cpu.py`` (imported here, with
JAX on the CPU; nothing in ``scripts/`` changes); a shrunk round of all
16 signatures and a run of ``--single`` pass on the plain versions; an
engine that drops one candidate makes the soak exit 1 with a repro line
that regenerates the very inputs the engine was given; the pool of oracle
processes changes no result; and without a card the tool exits non-zero
before any search.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from sassy_tpu_torch.ops import batch as port_batch
from sassy_tpu_torch.ops import myers_cuda, myers_torch
from sassy_tpu_torch.tools import soak

REPO = Path(__file__).resolve().parent.parent


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_batch():
    return _script("soak_batch")


@pytest.fixture(scope="module")
def ref_cpu():
    return _script("soak_cpu")


@pytest.fixture
def shrunk(monkeypatch):
    """Q and T of every signature cut to 2 x 2 (n, m, k, alpha, all_minima
    and reverse as they stand): a round of 16 groups, 64 pairs."""
    monkeypatch.setattr(soak, "SIGNATURES",
                        [(2, 2) + s[2:] for s in soak.SIGNATURES])
    return sum(s[0] * s[1] for s in soak.SIGNATURES)


def test_signatures_extend_the_reference_by_two_position_level_ones(
        ref_batch):
    assert soak.SIGNATURES[:14] == ref_batch.SIGNATURES
    assert soak.SIGNATURES[14:] == [
        (4, 48, 4096, 110, 10, 0.1, False, False),
        (4, 48, 4096, 110, 10, 0.1, True, True)]
    from sassy_tpu_torch import semantics

    # more overshoot steps than the word-level path's three words hold
    for Q, T, n, m, k, alpha, allm, rev in soak.SIGNATURES[14:]:
        assert semantics.overhang_steps(m, k, alpha, None) == 101 > 3 * 32
    assert sum(s[0] * s[1] for s in soak.SIGNATURES) == 8000


@pytest.mark.parametrize("sig", range(16))
def test_groups_equal_the_reference_scripts(ref_batch, sig):
    """``gen_group`` and the two spot draws after it, from the same
    ``(seed, group)`` generator, byte for byte."""
    for seed, gidx in ((0, sig), (7, sig + 16), (123, sig + 320)):
        got_sig, pats, texts, spot = soak.group(seed, gidx)
        assert got_sig == soak.SIGNATURES[sig]
        rng = np.random.default_rng((seed, gidx))
        want_p, want_t = ref_batch.gen_group(rng, got_sig)
        want_spot = [(int(rng.integers(0, got_sig[0])),
                      int(rng.integers(0, got_sig[1]))) for _ in range(2)]
        assert len(pats) == len(want_p) and len(texts) == len(want_t)
        assert all(a.tobytes() == b.tobytes() for a, b in zip(pats, want_p))
        assert all(a.tobytes() == b.tobytes() for a, b in zip(texts, want_t))
        assert all(a.dtype == b.dtype for a, b in zip(texts, want_t))
        assert spot == want_spot


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_cases_equal_the_reference_script(ref_cpu, seed):
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(60):
        a, b = soak.gen_case(ra), ref_cpu.gen_case(rb)
        assert a[3].tobytes() == b[3].tobytes()
        assert a[4].tobytes() == b[4].tobytes()
        assert a[:3] == b[:3] and a[5:] == b[5:]
    got, want = soak.repro_case(17, seed), ref_cpu.repro(17, seed)
    assert got[3].tobytes() == want[3].tobytes() and got[5:] == want[5:]


def test_a_shrunk_round_of_all_signatures_passes_on_the_cpu(shrunk):
    rec = soak.run(shrunk, 3, "cpu", 0, log=lambda msg: None)
    assert rec["ok"] and rec["pairs"] == shrunk
    assert rec["signatures"] == 16
    # the plain versions ran: no kernel launch counted on the CPU
    assert rec["launches"] == dict.fromkeys(soak.KERNELS, 0)
    assert soak.required(rec) == soak.KERNELS


def test_single_mode_passes_on_the_cpu():
    rec = soak.run(12, 5, "cpu", 0, single=True, log=lambda msg: None)
    assert rec["ok"] and rec["pairs"] == 12
    assert soak.required(rec) == ("q1meta", "q2meta")


def _drop_first_candidate(monkeypatch, cls, name):
    """Patch ``cls.name`` to drop one candidate of its first non-empty
    answer; returns a list that receives that call's arguments."""
    orig = getattr(cls, name)
    dropped = []

    def wrapped(self, *args, **kw):
        got = orig(self, *args, **kw)
        if dropped:
            return got
        if name == "candidates":
            if got:
                dropped.append(args)
                return got[1:]
            return got
        for q, row in enumerate(got):
            for t, cell in enumerate(row):
                if len(cell):
                    dropped.append(args)
                    got[q][t] = list(cell)[1:]
                    return got
        return got

    monkeypatch.setattr(cls, name, wrapped)
    return dropped


def test_an_engine_that_drops_a_candidate_fails_with_a_repro(
        shrunk, monkeypatch, tmp_path, capsys):
    dropped = _drop_first_candidate(monkeypatch, port_batch.BatchEngine,
                                    "candidates_many")
    assert soak.main(["--device", "cpu", "--workers", "0", "--pairs",
                      str(shrunk), "--seed", "9", "--log",
                      str(tmp_path / "log")]) == 1
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("MISMATCH")]
    assert len(line) == 1 and "pair=(q=" in line[0]
    repro = line[0].split("repro: python -m sassy_tpu_torch.tools.soak ")[1]
    gidx, seed = map(int, repro.split()[1:])
    assert repro.split()[0] == "--repro" and seed == 9
    assert not (tmp_path / "log").exists()
    # the repro line regenerates the inputs the engine dropped a candidate of
    monkeypatch.setattr(soak, "REPRO_DIR", tmp_path / "repro")
    assert soak.main(["--repro", str(gidx), str(seed)]) == 0
    saved = np.load(tmp_path / "repro" / f"group_{gidx}_seed{seed}.npz")
    arrays = [saved[f"arr_{i}"] for i in range(len(saved.files))]
    prof, pcodes, texts = dropped[0][:3]
    texts = texts.texts if hasattr(texts, "texts") else texts
    assert len(arrays) == len(pcodes) + len(texts)
    assert all(np.array_equal(prof.encode(a), p)
               for a, p in zip(arrays, pcodes))
    assert all(np.array_equal(a, t) for a, t in zip(arrays[len(pcodes):],
                                                    texts))


def test_single_mode_repro_names_the_failing_case(monkeypatch, tmp_path,
                                                  capsys):
    dropped = _drop_first_candidate(monkeypatch, myers_torch.TorchEngine,
                                    "candidates")
    assert soak.main(["--single", "--device", "cpu", "--workers", "0",
                      "--pairs", "30", "--seed", "4"]) == 1
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("MISMATCH")][0]
    assert "TorchEngine case=" in line
    case, seed = map(int, line.split("--single --repro ")[1].split())
    assert seed == 4
    monkeypatch.setattr(soak, "REPRO_DIR", tmp_path)
    assert soak.main(["--single", "--repro", str(case), str(seed)]) == 0
    saved = np.load(tmp_path / f"case_{case}_seed{seed}.npz")
    prof, pcode, text = dropped[0][:3]
    assert np.array_equal(prof.encode(saved["pat"]), pcode)
    assert np.array_equal(saved["text"], text)


def test_the_oracle_pool_changes_no_result(shrunk, monkeypatch):
    """Two oracle processes against none: the same pairs pass, and with a
    candidate dropped the same first mismatch and repro line."""
    quiet = dict(log=lambda msg: None)
    a = soak.run(shrunk, 11, "cpu", 0, **quiet)
    b = soak.run(shrunk, 11, "cpu", 2, **quiet)
    assert a["ok"] and b["ok"] and a["pairs"] == b["pairs"] == shrunk
    _drop_first_candidate(monkeypatch, port_batch.BatchEngine,
                          "candidates_many")
    c = soak.run(shrunk, 11, "cpu", 0, **quiet)
    _drop_first_candidate(monkeypatch, port_batch.BatchEngine,
                          "candidates_many")
    d = soak.run(shrunk, 11, "cpu", 2, **quiet)
    assert not c["ok"] and not d["ok"]
    assert (c["mismatch"], c["repro"]) == (d["mismatch"], d["repro"])


def test_a_passing_cpu_run_logs_only_where_asked(shrunk, monkeypatch,
                                                 tmp_path, capsys):
    default = tmp_path / "default_log.txt"
    monkeypatch.setattr(soak, "LOG", default)
    assert soak.main(["--device", "cpu", "--workers", "0", "--pairs",
                      "8"]) == 0
    out = capsys.readouterr().out.splitlines()
    rec = json.loads(out[-1])
    assert rec["ok"] and rec["device"] == "cpu" and "card" not in rec
    assert set(rec) >= {"pairs", "pairs_per_s", "card_s", "oracle_s",
                        "launches", "wall_s"}
    assert any(ln.startswith("SOAK PASSED: 8 pairs") for ln in out)
    assert not default.exists()
    log = tmp_path / "log.txt"
    assert soak.main(["--device", "cpu", "--workers", "0", "--pairs", "8",
                      "--log", str(log)]) == 0
    assert "SOAK PASSED: 8 pairs" in log.read_text()


def test_without_a_card_the_soak_exits_before_searching(monkeypatch,
                                                         tmp_path, capsys):
    import torch

    def refuse(*a, **kw):
        raise AssertionError("the CPU path ran")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("scan_meta_plain", "scan_q_meta_plain", "scan_plain",
                 "scan_q_plain"):
        monkeypatch.setattr(myers_cuda, name, refuse)
    monkeypatch.setattr(port_batch.BatchEngine, "candidates_many", refuse)
    monkeypatch.setattr(soak, "LOG", tmp_path / "log")
    assert soak.main(["--pairs", "8", "--workers", "0"]) == 2
    assert soak.main(["--single", "--device", "cuda", "--workers", "0"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "log").exists()


@pytest.fixture
def traced_sigs(monkeypatch):
    """Four shrunk signatures (2 x 2 pairs) for ``--trace``: overhang at
    the word level, overhang on both strands with all minima, both strands
    and the ascii pass without overhang, and the position level's
    overhang on both strands; two matches sampled a group."""
    sigs = [(2, 2) + soak.SIGNATURES[i][2:] for i in (4, 8, 11, 15)]
    monkeypatch.setattr(soak, "SIGNATURES", sigs)
    monkeypatch.setattr(soak, "TRACE_SAMPLE", 2)
    return sum(s[0] * s[1] for s in sigs)


def test_a_traced_round_holds_matches_to_the_scalar_traceback(traced_sigs,
                                                              capsys):
    assert soak.main(["--trace", "--device", "cpu", "--workers", "0",
                      "--pairs", str(traced_sigs)]) == 0
    out = capsys.readouterr().out.splitlines()
    rec = json.loads(out[-1])
    assert rec["ok"] and rec["pairs"] == traced_sigs
    # the sample and every spot pair's match, on both strands and ascii
    assert rec["traced"] > 4 * 2 and rec["trace_s"] > 0
    assert rec["trace_launches"] == 0  # the plain version on the CPU
    assert any("matches held to the scalar traceback" in ln for ln in out)


@pytest.mark.parametrize("what", ["cigar", "coordinate"])
def test_a_traced_round_fails_on_a_wrong_match(traced_sigs, monkeypatch,
                                               what, capsys):
    """A CIGAR that loses its last run, or a pattern end one short, on
    the card's side fails the traced soak with a repro line."""
    from sassy_tpu_torch import search, traceback

    if what == "cigar":
        cigars = traceback._cigars

        def lossy(ops):
            out = cigars(ops)
            if out and out[-1].ops:
                out[-1].ops.pop()
            return out

        monkeypatch.setattr(traceback, "_cigars", lossy)
    else:
        matches = search.Searcher._matches

        def short(self, *a, **kw):
            out = matches(self, *a, **kw)
            if out:
                out[0].pattern_end -= 1
            return out

        monkeypatch.setattr(search.Searcher, "_matches", short)
    monkeypatch.setattr(soak, "TRACE_SAMPLE", 1 << 20)
    assert soak.main(["--trace", "--device", "cpu", "--workers", "0",
                      "--pairs", str(traced_sigs)]) == 1
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("MISMATCH")]
    assert len(line) == 1 and " traced " in line[0]
    assert "repro: python -m sassy_tpu_torch.tools.soak --repro " in line[0]


def test_trace_is_refused_in_single_mode(capsys):
    with pytest.raises(SystemExit):
        soak.main(["--trace", "--single", "--device", "cpu"])
