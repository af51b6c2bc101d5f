"""The port's ascii ``Searcher`` on the CPU (the kernels' plain versions
with the ascii eq: 8 byte planes and the validity plane) against the JAX
package's numpy oracle and its XLA engine: Match lists with CIGAR, both
case modes, every byte value in text and pattern, the single and the
batched entry points."""

import numpy as np
import pytest

from sassy_tpu import Searcher as RefSearcher
from sassy_tpu import profiles as ref_profiles
from sassy_tpu_torch import Searcher, profiles

TEXT = (b"Say hello there, HELLO\xff\x00World; hallo wrld. The quick brown fox "
        b"jumps over the lazy dog\n\tHeLLo, w0rld! \x80\xfehello\x7f") * 4


def _key(m):
    return m.pattern_idx, m.text_idx, m.sort_key(), m.cigar.to_string()


def _same(got, want):
    assert [_key(m) for m in got] == [_key(m) for m in want], (got, want)


def _pair(case_sensitive, engine):
    return (Searcher(profiles.Ascii(case_sensitive=case_sensitive),
                     device="cpu"),
            RefSearcher(ref_profiles.Ascii(case_sensitive=case_sensitive),
                        engine=engine))


@pytest.mark.parametrize("engine", ["numpy", "xla"])
@pytest.mark.parametrize("case_sensitive", [True, False])
@pytest.mark.parametrize("method", ["search", "search_all"])
def test_single_entry_points_equal_reference(method, case_sensitive, engine):
    port, ref = _pair(case_sensitive, engine)
    n = 0
    for pat, k in ((b"hello", 1), (b"World", 2), (b"O\xff\x00W", 1),
                   (b"lazy dog\n", 0), (b"\x80\xfeHELLO", 2)):
        got = getattr(port, method)(pat, TEXT, k)
        _same(got, getattr(ref, method)(pat, TEXT, k))
        n += len(got)
    assert n


BATCHED = {
    "search_many": lambda s: s.search_many(
        [b"hello", b"quick", b"w0rld!"], [TEXT, TEXT[7:90], b"HELLO"], 1),
    "search_texts": lambda s: s.search_texts(
        b"Hello", [TEXT[:60], b"", TEXT[30:]], 1),
    "search_all_texts": lambda s: s.search_all_texts(
        b"the", [TEXT[:100], TEXT[50:200]], 1),
    "search_patterns": lambda s: s.search_patterns(
        [b"hello", b"World", b"\xff\x00Wor"], TEXT, 1),
    "search_encoded_patterns": lambda s: s.search_encoded_patterns(
        s.encode_patterns([b"hello", b"wrld."]), TEXT, 1),
    "search_all_encoded_patterns": lambda s: s.search_all_encoded_patterns(
        s.encode_patterns([b"brown", b"BROWN"], rc_anchor="end"), TEXT[:150],
        1),
}


@pytest.mark.parametrize("engine", ["numpy", "xla"])
@pytest.mark.parametrize("case_sensitive", [True, False])
@pytest.mark.parametrize("name", sorted(BATCHED))
def test_batched_entry_points_equal_reference(name, case_sensitive, engine):
    port, ref = _pair(case_sensitive, engine)
    got = BATCHED[name](port)
    assert got
    _same(got, BATCHED[name](ref))


def test_librs_example():
    """tests/test_basic.py, lib.rs:37-46: ABC in XXXABCXXX at k=1."""
    s = Searcher(profiles.Ascii(), rc=False, device="cpu")
    assert sorted(m.text_end for m in s.search_all(b"ABC", b"XXXABCXXX", 1)
                  ) == [5, 6, 7]
    (best,) = s.search(b"ABC", b"XXXABCXXX", 1)
    assert (best.text_start, best.text_end, best.cost,
            best.cigar.to_string()) == (3, 6, 0, "3=")


def test_case_modes():
    cs = Searcher(profiles.Ascii(case_sensitive=True), device="cpu")
    assert len(cs.search(b"Hello", b"say hello there", 0)) == 0
    assert len(cs.search(b"hello", b"say hello there", 0)) == 1
    ci = Searcher(profiles.Ascii(case_sensitive=False), device="cpu")
    assert len(ci.search(b"Hello", b"say hello there", 0)) == 1
    assert len(Searcher("ascii-insensitive", device="cpu").search(
        b"Hello", b"say hello there", 0)) == 1


def test_batch_example():
    """tests/test_batch.py's ascii case, on the port."""
    port, ref = _pair(False, "numpy")
    texts = [b"the quick brown fox jumps over the lazy dog",
             b"HELLO WORLD hello"]
    pats = [b"hello", b"quick"]
    got = port.search_many(pats, texts, 1)
    assert got
    _same(got, ref.search_many(pats, texts, 1))


def test_bytes_past_the_text_end_never_match():
    """A NUL pattern byte equals no position past the end: the validity
    plane gates the byte planes, whose padding is NUL too."""
    port, ref = _pair(True, "numpy")
    for text in (b"ab\x00", b"ab", b"\x00" * 33, b"a" * 31 + b"\x00"):
        for fn in ("search", "search_all"):
            _same(getattr(port, fn)(b"\x00\x00", text, 1),
                  getattr(ref, fn)(b"\x00\x00", text, 1))
    assert port.search(b"\x00\x00", b"ab", 0) == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_bytes_equal_oracle(seed):
    """Random texts over a small byte alphabet with upper and lower case
    and bytes above 127, long enough for several tiles."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"aAbB\xe9\xc9 \x00", np.uint8)
    text = alphabet[rng.integers(0, len(alphabet), 3000)]
    for case_sensitive in (True, False):
        port, ref = _pair(case_sensitive, "numpy")
        for m, k in ((5, 1), (12, 3), (40, 6)):
            start = int(rng.integers(0, len(text) - m))
            pat = text[start : start + m].copy()
            pat[m // 2] = ord("b")
            got = port.search(pat, text, k)
            assert got
            _same(got, ref.search(pat, text, k))


def test_ascii_name_turns_rc_off():
    assert Searcher("ascii", rc=True, device="cpu").rc is False
    assert Searcher("ascii-insensitive", rc=True, device="cpu").rc is False
    # a profile object keeps rc, and the search then fails as the
    # reference's does: ascii has no complement
    s = Searcher(profiles.Ascii(), rc=True, device="cpu")
    assert s.rc is True
    with pytest.raises(NotImplementedError, match="no complement"):
        s.search(b"abc", b"xxabcxx", 1)


def test_ascii_has_no_overhang():
    with pytest.raises(ValueError, match="overhang is not supported"):
        Searcher("ascii", alpha=0.5, device="cpu")
    with pytest.raises(ValueError, match="overhang is not supported"):
        Searcher(profiles.Ascii(), device="cpu").with_overhang(0.5)


def test_ascii_runs_the_ascii_eq(monkeypatch):
    """Both engines hand the scan the ascii eq with nine planes and eight
    mask columns, never the pure shortcut."""
    from sassy_tpu_torch.ops import myers_cuda

    seen = []
    for name in ("scan_meta", "scan_q_meta"):
        fn = getattr(myers_cuda, name)

        def spy(*args, _fn=fn, _name=name):
            lead = 1 if _name == "scan_q_meta" else 0
            seen.append((_name, args[-1], args[0].shape[1],
                         args[4].shape[lead + 1]))
            return _fn(*args)

        monkeypatch.setattr(myers_cuda, name, spy)
    s = Searcher(profiles.Ascii(case_sensitive=False), device="cpu")
    assert s.search(b"ACGT", b"ttacgttt", 0)
    assert s.search_many([b"ACGT"], [b"ttacgttt"], 0)
    assert seen == [("scan_meta", "ascii", 9, 8),
                    ("scan_q_meta", "ascii", 9, 8)]
