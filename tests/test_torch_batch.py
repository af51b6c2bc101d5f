"""The port's batched engine against the JAX package: the piece planner,
the piece windows, ``BatchEngine`` candidate lists against
``sassy_tpu.ops.batch.BatchEngine(backend="xla")``, chunking, and every
batched ``Searcher`` entry point against ``sassy_tpu.Searcher`` (XLA
engine and numpy oracle), Match for Match with CIGAR."""

import threading
from pathlib import Path

import numpy as np
import pytest

from sassy_tpu import Searcher as RefSearcher
from sassy_tpu import profiles as ref_profiles
from sassy_tpu.ops import batch as ref_batch
from sassy_tpu.search import NumpyEngine
from sassy_tpu_torch import Searcher, profiles
from sassy_tpu_torch.ops import batch

BASES = np.frombuffer(b"ACGT", np.uint8)
# each package gets its own profile objects
PROFILES = {
    "dna": profiles.Dna(),
    "iupac": profiles.Iupac(),
    "ascii": profiles.Ascii(case_sensitive=False),
}
REF_PROFILES = {
    "dna": ref_profiles.Dna(),
    "iupac": ref_profiles.Iupac(),
    "ascii": ref_profiles.Ascii(case_sensitive=False),
}


def _texts(rng, count, lo, hi, alphabet=b"ACGT"):
    alpha = np.frombuffer(alphabet, np.uint8)
    return [rng.choice(alpha, int(n)) for n in rng.integers(lo, hi, count)]


def _key(m):
    return m.sort_key(), m.cigar.to_string()


def _same(got, want):
    """Equal Match lists, field for field with the CIGAR string (the two
    packages' Match classes differ, so ``same_as`` cannot compare them)."""
    assert len(got) == len(want), (len(got), len(want), got[:3], want[:3])
    assert [_key(m) for m in got] == [_key(m) for m in want]


@pytest.mark.parametrize("seed", range(4))
def test_planner_equals_reference(seed):
    rng = np.random.default_rng(seed)
    lens = [0, 1, 31, 32, 33] + rng.integers(0, 20000, 40).tolist()
    for halo in (9, 27, 75, 140):
        for w_cap in (16, 64, 100, 320, 8192):
            assert batch._pick_w_words(lens, 0, halo, w_cap) == \
                ref_batch._pick_w_words(lens, 0, halo, w_cap, 1)
        for w_words in (8, 16, 40, 64, 320):
            w_chars = w_words * 32
            if w_chars <= halo + 32:
                continue
            got = batch._plan_pieces(lens, 0, w_chars, halo)
            want = ref_batch._plan_pieces(lens, 0, w_chars, halo)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert vars(a) == {f: getattr(b, f) for f in vars(a)}
    for cap in (16, 17, 100, 1000, 8192):
        assert batch._w_lattice(cap) == ref_batch._w_lattice(cap)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("prof_name", ["dna", "iupac", "ascii"])
def test_piece_windows_equal_reference(prof_name, reverse):
    """The windows gathered from the device planes equal the JAX package's
    host packing, ``_pack_pieces_np``, bit for bit: the right-context word
    and the zero tail past each text's end included."""
    prof = PROFILES[prof_name]
    alphabet = {"dna": b"ACGTacgtN", "iupac": b"ACGTNRYacgt-",
                "ascii": b"Hello, World! hello"}[prof_name]
    rng = np.random.default_rng(len(prof_name) + int(reverse))
    texts = _texts(rng, 9, 0, 900, alphabet) + [np.zeros(0, np.uint8)]
    texts[2] = texts[2][:1]
    ts = batch.TextSet(texts, "cpu")
    ref_ts = ref_batch.TextSet(texts)
    halo, w_chars = 27, 256
    pp = ts.piece_plan(halo, w_chars)
    pieces = ref_batch._plan_pieces(ts.lens, 0, w_chars, halo)
    want = ref_batch._pack_pieces_np(
        REF_PROFILES[prof_name], ref_ts._texts_for(reverse), pieces, w_chars, 0
    ).transpose(2, 0, 1).view(np.int32)
    assert pp.T == len(pieces) and pp.NW == want.shape[0]
    np.testing.assert_array_equal(
        ts.windows(prof, pp, reverse, 0, pp.T).numpy(), want)
    np.testing.assert_array_equal(  # one dispatch chunk's slice
        ts.windows(prof, pp, reverse, 3, 11).numpy(), want[:, :, 3:11])


def _reference_engine(w_max_words=None):
    kw = {} if w_max_words is None else {"w_max_words": w_max_words}
    return ref_batch.BatchEngine(backend="xla", **kw)


# tests/test_batch.py's shapes (no overhang):
# (profile, texts (count, lo, hi), pattern lengths, k, w_max_words)
CASES = {
    "search_many": ("iupac", (5, 50, 400), [12] * 4, 2, None),
    "unequal_lengths": ("dna", (3, 100, 300), [8, 23, 40, 150], 3, None),
    "segmentation": ("iupac", (2, 5000, 7000), [24], 3, 64),
    "texts_and_patterns": ("iupac", (6, 30, 200), [15] * 5, 2, None),
    "empty_and_tiny": ("iupac", (4, 0, 9), [4], 1, None),
}


@pytest.mark.parametrize("all_minima", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_candidates_many_equals_reference(case, reverse, all_minima,
                                          monkeypatch):
    prof_name, (count, lo, hi), ms, k, w_max = CASES[case]
    prof = PROFILES[prof_name]
    rng = np.random.default_rng(len(case))
    texts = _texts(rng, count, lo, hi)
    pats = [rng.choice(BASES, m) for m in ms]
    for i, t in enumerate(texts):  # planted copies, at piece edges too
        p = pats[i % len(pats)]
        # the reversed pattern matches on the reversed text
        for off, seq in ((0, p), (101, p[::-1]), (1000, p), (2040, p),
                         (2047, p[::-1]), (2049, p), (len(t) - len(p), p[::-1])):
            if 0 <= off <= len(t) - len(p):
                t[off : off + len(p)] = seq
    codes = [prof.encode(p) for p in pats]
    if w_max:
        monkeypatch.setattr(batch, "W_MAX_WORDS", w_max)
    ref = _reference_engine(w_max_words=w_max)
    args = (prof, codes, texts, k)
    ref_args = (REF_PROFILES[prof_name], codes, texts, k)
    kw = dict(all_minima=all_minima, reverse=reverse)
    got = batch.BatchEngine("cpu").candidates_many(*args, **kw)
    assert got == ref.candidates_many(*ref_args, **kw)
    assert any(c for row in got for c in row) or case == "empty_and_tiny"
    flat = batch.BatchEngine("cpu").candidates_many_flat(*args, **kw)
    for a, b in zip(flat, ref.candidates_many_flat(*ref_args, **kw)):
        np.testing.assert_array_equal(a, b)


def test_ascii_candidates_equal_reference():
    prof = PROFILES["ascii"]
    texts = [b"the quick brown fox jumps over the lazy dog", b"HELLO WORLD hello"]
    codes = [prof.encode(p) for p in (b"hello", b"quick")]
    got = batch.BatchEngine("cpu").candidates_many(prof, codes, texts, 1)
    assert got == _reference_engine().candidates_many(
        REF_PROFILES["ascii"], codes, texts, 1)
    assert got[0][1]


@pytest.mark.parametrize("budget_pairs", [1, 3, 7])
def test_chunking_does_not_change_results(budget_pairs, monkeypatch):
    """Dispatch chunks of a few (pattern, piece) pairs give what one chunk
    gives, and what the oracle gives per (pattern, text): the state chain
    is carried across tile chunks, so plateaus that cross a chunk edge
    resolve as in one piece. Low-complexity texts at a high k make many
    such plateaus; the JAX package truncates them to state 0 at its chunk
    edges."""
    prof = PROFILES["dna"]
    rng = np.random.default_rng(budget_pairs)
    texts = _texts(rng, 3, 1500, 2500, b"AAAAAAACG")
    pats = [rng.choice(np.frombuffer(b"AAAC", np.uint8), 16) for _ in range(3)]
    codes = [prof.encode(p) for p in pats]
    monkeypatch.setattr(batch, "W_MAX_WORDS", 16)  # pieces of 512 chars
    whole = batch.BatchEngine("cpu").candidates_many(prof, codes, texts, 5)
    n_words = 16 + 1
    monkeypatch.setattr(batch, "DISPATCH_BYTES", 16 * n_words * budget_pairs)
    chunked = batch.BatchEngine("cpu").candidates_many(prof, codes, texts, 5)
    assert chunked == whole
    oracle = NumpyEngine()
    for q, c in enumerate(codes):
        for t, text in enumerate(texts):
            want = oracle.candidates(REF_PROFILES["dna"], c, text, 5, None,
                                     None, False)
            assert list(whole[q][t]) == sorted(want), (q, t)


def _fasta(path):
    recs, cur = [], []
    for line in path.read_text().splitlines():
        if line.startswith(">"):
            if cur:
                recs.append("".join(cur).encode())
            cur = []
        elif line.strip():
            cur.append(line.strip())
    if cur:
        recs.append("".join(cur).encode())
    return recs


GOLDEN = Path(__file__).parent / "golden"
PATTERNS = [p.encode() for p in (GOLDEN / "patterns2.txt").read_text().split()]
RECORDS = _fasta(GOLDEN / "corpus2.fa")[24:36]  # 0.3-2 kbp, with matches
MIXED = PATTERNS[:6]  # 5-31 bp: four row buckets
EQUAL = [p[:16] for p in PATTERNS if len(p) >= 16][:5]  # equal lengths


def _keep_even(pattern, text_up_to_end, strand):
    return len(text_up_to_end) % 2 == 0


ENTRY_POINTS = {
    "search_many": lambda s, k: s.search_many(MIXED, RECORDS, k),
    "search_texts": lambda s, k: s.search_texts(MIXED[4], RECORDS, k),
    "search_all_texts": lambda s, k: s.search_all_texts(MIXED[3], RECORDS, k),
    "search_patterns": lambda s, k: s.search_patterns(
        EQUAL, b"".join(RECORDS[:8]), k),
    "search_encoded_patterns_start": lambda s, k: s.search_encoded_patterns(
        s.encode_patterns(EQUAL), b"".join(RECORDS[2:9]), k),
    "search_encoded_patterns_end": lambda s, k: s.search_encoded_patterns(
        s.encode_patterns(EQUAL, rc_anchor="end"), b"".join(RECORDS[2:9]), k),
    "search_all_encoded_patterns_start":
        lambda s, k: s.search_all_encoded_patterns(
            s.encode_patterns(EQUAL), b"".join(RECORDS[:6]), k),
    "search_all_encoded_patterns_end":
        lambda s, k: s.search_all_encoded_patterns(
            s.encode_patterns(EQUAL, rc_anchor="end"), b"".join(RECORDS[:6]), k),
    "search_many_with_fn": lambda s, k: s.search_many_with_fn(
        MIXED, RECORDS, k, False, _keep_even),
    "search_many_with_fn_async": lambda s, k: s.search_many_with_fn_async(
        MIXED, RECORDS, k, True, _keep_even)(),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_batched_entry_points_equal_reference(name):
    call = ENTRY_POINTS[name]
    k = 2
    got = call(Searcher("iupac", rc=True, device="cpu"), k)
    assert got, "the golden subset must give matches"
    _same(got, call(RefSearcher("iupac", rc=True, engine="numpy"), k))
    _same(got, call(RefSearcher("iupac", rc=True, engine="xla"), k))


def test_batched_engine_errors_propagate(monkeypatch):
    """No pairwise fallback: an error of the batched engine reaches the
    caller of every batched entry point."""
    s = Searcher("dna", rc=True, device="cpu")

    def boom(*args, **kw):
        raise ValueError("batched engine failed")

    calls = (
        lambda: s.search_many([b"ACGT"], [b"ACGTACGT"], 1),
        lambda: s.search_texts(b"ACGT", [b"ACGTACGT"], 1),
        lambda: s.search_many_with_fn_async([b"ACGT"], [b"ACGT"], 1, False,
                                            None)(),
    )
    # raised where the dispatch starts, and on the dispatch thread
    for name in ("candidates_many_async", "dispatch"):
        with monkeypatch.context() as m:
            m.setattr(s.batch, name, boom)
            for call in calls:
                with pytest.raises(ValueError, match="batched engine failed"):
                    call()


def test_candidates_many_async_returns_before_the_dispatch_ends(monkeypatch):
    """The device work runs on the dispatch thread: ``candidates_many_async``
    returns while that work is held, and ``finish()`` waits for it."""
    prof = PROFILES["dna"]
    codes = [prof.encode(b"ACGTTGCA"), prof.encode(b"GGATCC")]
    texts = [b"TTACGTTGCATTGGATCA", b"GGATCCACGTAGCA"]
    want = batch.BatchEngine("cpu").candidates_many(prof, codes, texts, 1)
    eng = batch.BatchEngine("cpu")
    release = threading.Event()
    dispatch = eng.dispatch

    def held(*args, **kw):
        assert release.wait(timeout=30), "the caller waited for the dispatch"
        return dispatch(*args, **kw)

    monkeypatch.setattr(eng, "dispatch", held)
    finish = eng.candidates_many_async(prof, codes, texts, 1)
    release.set()
    assert finish() == want and want[0][0] and want[1][1]


def test_textset_on_another_device_is_refused():
    ts = batch.TextSet([b"ACGT"], "meta")
    with pytest.raises(ValueError, match="TextSet on meta"):
        batch.BatchEngine("cpu").candidates_many(
            PROFILES["dna"], [PROFILES["dna"].encode(b"ACGT")], ts, 1)
