"""The port's evals harness (``sassy_tpu_torch.evals.bench_suite``) on the
CPU, against the JAX package's ``evals/bench_suite.py``: the CSV schema
and its statistics, the chunked ``sim_text`` (same seeds, same bytes, same
generator state after), each batched bench's match counts under tiny
configs against the JAX ``Runner`` on the CPU, the throughput rows'
counts against the numpy oracle on the same bytes, and ``--device cuda``
without a card."""

import csv
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from sassy_tpu import profiles as ref_profiles
from sassy_tpu.search import NumpyEngine
from sassy_tpu_torch.evals import bench_suite as port

REPO = Path(__file__).resolve().parent.parent


def _reference():
    spec = importlib.util.spec_from_file_location(
        "ref_bench_suite", REPO / "evals" / "bench_suite.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _reference()

#: the benches' configs at a few kbp (the same keys as evals/configs/)
TINY = {
    "nanopore": """num_queries = 6
query_len = 24
total_bp = 24000
read_len = 1200
ks = [3, 4]
plant_every = 500
""",
    "nanopore_full": """num_queries = 5
query_len = 24
total_bp = 20000
read_len = 2500
ks = [3]
plant_every = 700
""",
    "off_targets": """num_queries = 8
query_len = 23
k = 3
genome_bp = 30000
plant_every = 2000
""",
    "off_targets_full": """num_queries = 12
query_len = 23
k = 3
genome_bp = 40000
plant_every = 3000
""",
    "text_scaling": """target_len = 3000
query_len = 23
k = 3
num_queries = [1, 3]
amortize_to_bp = 9000
""",
    "pattern_scaling": """num_queries = 4
query_len = 23
target_lens = [50, 400]
ks = [0, 3]
amortize_to_bp = 1200
""",
    "throughput": """[throughput_m]
n = 6000
k = 5
ms = [16, 23, 70]

[throughput_n]
m = 16
k = 5
ns = [3000, 9000]
""",
}
BATCHED = ["nanopore", "nanopore_full", "off_targets", "off_targets_full",
           "text_scaling", "pattern_scaling"]


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    cfg = tmp_path / "configs"
    cfg.mkdir()
    for name, body in TINY.items():
        (cfg / f"{name}.toml").write_text(body)
    monkeypatch.setattr(port, "CONFIG_DIR", cfg)
    monkeypatch.setattr(ref, "CONFIG_DIR", cfg)
    # the edlib columns are not compared: keep the reference's refcost
    # loader (which builds into native/) out of it
    monkeypatch.setattr(ref, "refcost_rate_bps", lambda *a: 0.0)
    return tmp_path


def _rows(path: Path) -> list[list[str]]:
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def test_header_and_stats_row_equal_reference():
    assert port.HEADER == ref.HEADER and len(port.HEADER) == 35
    for times, n, tb in [([1.5, 2.25, 3.0], 7, 10**6), ([0.4], 0, 64),
                         ([5.0, 5.0], 3, 3 * 10**9), ([0.0, 1.0], 1, 10)]:
        assert port.stats_row(times, n, tb) == ref.stats_row(times, n, tb)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("chunk", [777, 4096])
def test_chunked_sim_text_equals_reference(seed, chunk, monkeypatch):
    """Same bytes with the planted copies, and the generator left in the
    same state, whatever the chunk."""
    monkeypatch.setattr(port, "SIM_CHUNK", chunk)
    n = 30_011
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    qa = [a.choice(port.BASES, size=23) for _ in range(5)]
    qb = [b.choice(ref.BASES, size=23) for _ in range(5)]
    kw = dict(plant_every=1000, k=3) if seed % 2 else {}
    got = port.sim_text(a, n, qa, **kw)
    want = ref.sim_text(b, n, qb, **kw)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert a.integers(0, 1 << 62) == b.integers(0, 1 << 62)


@pytest.mark.parametrize("bench", BATCHED)
def test_batched_bench_counts_equal_jax_runner(bench, tiny):
    port.main([bench, "--out", str(tiny / "port"), "--reps", "1",
               "--device", "cpu"])
    ref.main([bench, "--out", str(tiny / "ref"), "--reps", "1"])
    got = _rows(tiny / "port" / f"{bench}_results.csv")
    want = _rows(tiny / "ref" / f"{bench}_results.csv")
    assert got[0] == want[0] == ref.HEADER
    assert len(got) == len(want) > 1
    h = ref.HEADER
    keys = [h.index(c) for c in ("num_queries", "target_len", "query_len",
                                 "k", "search_n_matches", "tiling_n_matches",
                                 "throughput_bytes")]
    assert [[r[i] for i in keys] for r in got[1:]] == \
        [[r[i] for i in keys] for r in want[1:]]
    s, t = h.index("search_n_matches"), h.index("tiling_n_matches")
    assert all(r[s] == r[t] for r in got[1:])
    if bench.startswith(("nanopore", "off_targets")):
        assert all(int(r[s]) > 0 for r in got[1:])
        # the port's refcost fills the edlib columns
        assert all(float(r[h.index("edlib_throughput_gbps")]) >= 0
                   for r in got[1:])


@pytest.mark.parametrize("bench", ["throughput_m", "throughput_n"])
def test_throughput_rows_equal_numpy_oracle(bench, tiny):
    """The rows' candidate counts equal the numpy oracle's over the same
    device-made text and the same patterns (the rows' seed 5)."""
    port.main([bench, "--out", str(tiny), "--reps", "1", "--device", "cpu"])
    rows = _rows(tiny / f"{bench}_results.csv")[1:]
    h = port.HEADER
    rng = np.random.default_rng(5)
    prof = ref_profiles.Iupac()
    total = 0
    for r in rows:
        n, m, k = (int(r[h.index(c)]) for c in ("target_len", "query_len",
                                                 "k"))
        text = port.device_text(n, "cpu").numpy()
        pat = prof.encode(rng.choice(port.BASES, size=m))
        want = NumpyEngine().candidates(prof, pat, text, k, None, None, False)
        assert int(r[h.index("search_n_matches")]) == len(want), (n, m, k)
        assert r[h.index("tiling_n_matches")] == "0"
        total += len(want)
    assert total > 0


def test_device_text_is_seeded_by_its_length():
    a = port.device_text(5000, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (5000,)
    assert torch.equal(a, port.device_text(5000, "cpu"))
    assert set(a.unique().tolist()) == set(b"ACGT")


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("SASSY_DEVICE", raising=False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["nanopore", "--out", str(out)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["nanopore", "--out", str(out), "--device", "cuda"])
    monkeypatch.setenv("SASSY_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["nanopore", "--out", str(out)])
    assert not out.exists()


def test_planted_sites_tool_finds_every_site(tiny, capsys):
    """``tools.planted_sites`` over the bench's own data (tiny config):
    every planted guide copy is a candidate of its guide, from one call of
    all guides and from guide 0 alone."""
    from sassy_tpu_torch.tools import planted_sites

    assert planted_sites.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "planted sites found 13/13 below 2^31, 0/0 past it" in out
    assert "guide 0: " in out and "missing" not in out
