"""The Searcher's host finish as arrays: the filters, the best-match
choice and the traceback over all candidates of a strand at once, against
``sassy_tpu.Searcher(engine="xla")``, Match for Match in the same order
with CIGARs; the window gather, the fill's chunking and a failed walk's
diagnostics; the Match build (one run tuple a distinct CIGAR, positional
Match calls, the collector held off) against a per-object construction,
its objects, its types and the collector's state."""

import gc
import threading

import numpy as np
import pytest

from sassy_tpu import Searcher as RefSearcher
from sassy_tpu_torch import (Searcher, cli, collector, nfilter, profiles,
                             traceback)
from sassy_tpu_torch.cigar import Cigar
from sassy_tpu_torch.matchrec import UNKNOWN, Match, Strand

BASES = np.frombuffer(b"ACGT", np.uint8)


def _key(m):
    return m.sort_key(), m.cigar.to_string()


def _same(got, want):
    assert len(got) == len(want), (len(got), len(want), got[:3], want[:3])
    assert [_key(m) for m in got] == [_key(m) for m in want]


def _inputs(profile: str, kind: str = ""):
    """Seeded patterns of two lengths (24 and 16 bp; with IUPAC codes for
    the iupac profile) and reads of 60-260 bp holding copies of them with
    up to two edits, forward or reverse-complemented, some hanging off a
    read's end, and runs of N inside reads, at their ends and over copies.
    ``kind`` "sparse": 240 reads of which 6 hold a copy; "n_runs": three
    runs of 1-20 N next to or over each copy, so that the N filters
    decide many candidates."""
    rng = np.random.default_rng(16)
    prof = profiles.get_profile(profile)
    pats = [rng.choice(BASES, 24) for _ in range(3)]
    pats += [rng.choice(BASES, 16) for _ in range(2)]
    if profile == "iupac":
        pats[1][[5, 17]] = (ord("R"), ord("Y"))
        pats[3][8] = ord("N")
    n_reads = 240 if kind == "sparse" else 36
    reads = []
    for i in range(n_reads):
        body = rng.choice(BASES, int(rng.integers(60, 261)))
        n = len(body)
        if kind == "sparse" and i % 40 != 7:
            reads.append(body)
            continue
        p = pats[i % len(pats)].copy()
        for _ in range(i % 3):
            p[int(rng.integers(0, len(p)))] = BASES[int(rng.integers(0, 4))]
        if i % 2:
            p = np.frombuffer(prof.reverse_complement(p), np.uint8)
        where = i % 6
        if where == 4:  # hangs off the read's start
            at = 5 - len(p)
            body[: len(p) - 5] = p[5:]
        elif where == 5:  # hangs off the read's end
            at = n - (len(p) - 4)
            body[at:] = p[: len(p) - 4]
        else:
            at = int(rng.integers(0, n - len(p)))
            body[at : at + len(p)] = p
        if kind == "n_runs":
            for _ in range(3):
                ln = int(rng.integers(1, 21))
                s = min(max(0, at + int(rng.integers(-ln, len(p)))), n - ln)
                body[s : s + ln] = ord("N") if ln % 2 else ord("n")
        if i % 4 == 1:  # an N run inside, over part of a copy
            s = int(rng.integers(0, n - 12))
            body[s : s + 12] = ord("N")
        if i % 9 == 2:  # N runs at both ends
            body[:7] = ord("N")
            body[-9:] = ord("n")
        reads.append(body)
    return pats, reads


def _keep_some(pattern, text_up_to_end, strand):
    return (len(text_up_to_end) + len(pattern) + int(strand)) % 3 != 0


#: name -> (profile, k, Searcher options, entry point, read set). The
#: overhang cases search the 24 bp patterns only: the reference's batched
#: engine takes overhang on equal lengths (others loop over pairs)
CASES = {
    "dna": ("dna", 2, {}, "search_many", ""),
    "dna_fwd": ("dna", 2, {"rc": False}, "search_many", ""),
    "iupac": ("iupac", 3, {}, "search_many", ""),
    "iupac_fwd_texts": ("iupac", 3, {"rc": False}, "search_texts", ""),
    "dna_texts": ("dna", 2, {}, "search_texts", ""),
    "all_minima": ("iupac", 3, {}, "all_minima", ""),
    "all_minima_filter_fn": ("dna", 2, {}, "all_minima_filter", ""),
    "filter_fn": ("iupac", 3, {}, "filter", ""),
    "only_best": ("iupac", 3, {"only_best": True}, "search_many", ""),
    "only_best_all_minima": ("dna", 2, {"only_best": True}, "all_minima",
                             ""),
    "without_trace": ("iupac", 3, {"without_trace": True}, "search_many",
                      ""),
    "without_trace_fwd": ("dna", 2, {"without_trace": True, "rc": False},
                          "all_minima", ""),
    "max_n_frac": ("iupac", 3, {"max_n_frac": 0.1}, "search_many", ""),
    "max_n_frac_all_minima": ("iupac", 3, {"max_n_frac": 0.25},
                              "all_minima", ""),
    "max_n_frac_without_trace": ("iupac", 3, {"max_n_frac": 0.1,
                                              "without_trace": True},
                                 "all_minima", ""),
    "alpha": ("iupac", 3, {"alpha": 0.5}, "search_many", ""),
    "alpha_max_overhang": ("iupac", 3, {"alpha": 0.5, "max_overhang": 3},
                           "all_minima", ""),
    "alpha_only_best_n_frac": ("iupac", 3, {"alpha": 0.5, "only_best": True,
                                            "max_n_frac": 0.2},
                               "search_texts", ""),
    "n_runs_all_minima": ("iupac", 3, {"max_n_frac": 0.4}, "all_minima",
                          "n_runs"),
    "n_runs_only_best": ("iupac", 3, {"max_n_frac": 0.5, "only_best": True},
                         "search_many", "n_runs"),
    "sparse": ("dna", 2, {}, "search_many", "sparse"),
    "sparse_only_best": ("iupac", 3, {"only_best": True}, "filter", "sparse"),
}


def _searcher(cls, profile: str, opts: dict, **kw):
    s = cls(profile, rc=opts.get("rc", True), alpha=opts.get("alpha"), **kw)
    if "max_overhang" in opts:
        s.with_max_overhang(opts["max_overhang"])
    if opts.get("only_best"):
        s.only_best_match()
    if opts.get("without_trace"):
        s.without_trace()
    if "max_n_frac" in opts:
        s.with_max_n_frac(opts["max_n_frac"])
    return s


def _call(s, entry: str, pats, reads, k: int):
    if entry == "search_many":
        return s.search_many(pats, reads, k)
    if entry == "search_texts":
        return s.search_texts(pats[0], reads, k)
    if entry == "all_minima":
        return s.search_many_with_fn(pats, reads, k, True, None)
    return s.search_many_with_fn(pats, reads, k, entry == "all_minima_filter",
                                 _keep_some)


@pytest.mark.parametrize("case", list(CASES))
def test_finish_equals_reference(case):
    profile, k, opts, entry, kind = CASES[case]
    pats, reads = _inputs(profile, kind)
    if "alpha" in opts:
        pats = pats[:3]
    got = _call(_searcher(Searcher, profile, opts, device="cpu"), entry,
                pats, reads, k)
    assert got, "the case should give matches"
    want = _call(_searcher(RefSearcher, profile, opts, engine="xla"), entry,
                 pats, reads, k)
    _same(got, want)


@pytest.mark.parametrize("opts", [{}, {"max_n_frac": 0.2},
                                  {"only_best": True, "alpha": 0.5}])
def test_single_path_is_the_same_finish(opts):
    """``search`` (the single engine) over each read equals the batched
    finish's matches of that read, text index aside."""
    pats, reads = _inputs("iupac")
    s = _searcher(Searcher, "iupac", opts, device="cpu")
    many = s.search_many(pats[:1], reads[:12], 3)
    single = []
    for ti, read in enumerate(reads[:12]):
        for m in s.search(pats[0], read, 3):
            m.text_idx = ti
            single.append(m)
    assert many and [_key(m) for m in single] == [_key(m) for m in many]


def _naive_windows(texts, tids, starts, lens, width, reverse):
    out = np.zeros((len(tids), width), np.uint8)
    for b, (t, s, n) in enumerate(zip(tids, starts, lens)):
        src = texts[t][::-1] if reverse else texts[t]
        out[b, :n] = src[s : s + n]
    return out


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("copy_cap", [1 << 16, 40])
@pytest.mark.parametrize("n_gather_cost", [0, 1 << 30])
def test_text_spans_equal_slicing(reverse, copy_cap, n_gather_cost,
                                  monkeypatch):
    """Each row is its text's slice (of the text read backwards with
    ``reverse``), and the N count of any range inside it that slice's:
    through the copied spans, and in place where a text's span passes the
    cap; counted by a gather (cost 0) or in the N positions (a cost no
    source passes); rows of length 0 and blocks of rows."""
    monkeypatch.setattr(traceback, "SPAN_COPY_BYTES", copy_cap)
    monkeypatch.setattr(traceback, "N_GATHER_COST", n_gather_cost)
    monkeypatch.setattr(traceback, "GATHER_ROWS", 7)
    rng = np.random.default_rng(5)
    texts = [rng.choice(np.frombuffer(b"ACGNn", np.uint8), int(n))
             for n in (0, 5, 90, 300, 31)]
    lens_t = np.array([len(t) for t in texts])
    tids = rng.choice(np.flatnonzero(lens_t), 60)
    width = 12
    lens = rng.integers(0, width + 1, 60) % (lens_t[tids] + 1)
    starts = rng.integers(0, lens_t[tids] - lens + 1)
    spans = traceback.TextSpans(texts, lens_t, tids, starts, lens, reverse)
    want = _naive_windows(texts, tids, starts, lens, width, reverse)
    np.testing.assert_array_equal(spans.windows(width), want)
    a = starts + rng.integers(0, lens + 1) // 2
    z = np.maximum(a, starts + lens - rng.integers(0, lens + 1) // 2)
    cols = np.arange(width)
    is_n = (want == ord("N")) | (want == ord("n"))
    inside = ((cols >= (a - starts)[:, None])
              & (cols < (z - starts)[:, None]))
    np.testing.assert_array_equal(spans.n_counts(a, z),
                                  np.count_nonzero(is_n & inside, axis=1))


def test_fill_chunks_give_the_same_matches(monkeypatch):
    """A fill capped at a few candidates' matrices traces in chunks and
    gives the same matches as one fill."""
    pats, reads = _inputs("iupac")
    s = Searcher("iupac", rc=True, device="cpu")
    want = s.search_many_with_fn(pats, reads, 3, True, None)
    calls = []
    fill = traceback._fill_batch

    def counted(profile, pcodes, wins, *a):
        calls.append(len(wins))
        return fill(profile, pcodes, wins, *a)

    def per_window(m, w):  # its int32 cost matrix and its match mask
        return (m + 1) * (w + 1) * 4 + m * w

    monkeypatch.setattr(traceback, "_fill_batch", counted)
    monkeypatch.setattr(traceback, "FILL_BYTES", 3 * per_window(24, 27))
    got = s.search_many_with_fn(pats, reads, 3, True, None)
    # 3 windows of the 24 bp patterns, 6 of the 16 bp ones
    assert 3 * per_window(24, 27) // per_window(16, 19) == 6
    assert max(calls) == 6 and len(calls) > 10
    _same(got, want)


@pytest.mark.parametrize("alpha", [None, 0.5])
def test_fill_routes_agree(alpha, monkeypatch):
    """The fill's running minimum, one accumulate (few candidates) or one
    operation a column (many), gives the same matrices and masks."""
    prof = profiles.Iupac()
    rng = np.random.default_rng(11)
    codes = prof.encode(rng.choice(np.frombuffer(b"ACGTNRY", np.uint8),
                                   (50, 31)))
    pcodes = prof.encode(rng.choice(np.frombuffer(b"ACGTR", np.uint8),
                                    (50, 24)))
    got = []
    for below in (0, 1 << 30):
        monkeypatch.setattr(traceback, "ACCUMULATE_BELOW", below)
        got.append(traceback._fill_batch(prof, pcodes, codes, alpha, None))
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_n_frac", [None, 0.3])
def test_traceback_gathers_no_host_window(max_n_frac, monkeypatch):
    """The traceback reads its windows from the strands' planes: without
    ``max_n_frac`` neither engine's finish builds a ``TextSpans`` (no host
    window is gathered); with it, only the N counts do, and never a
    window's bytes."""
    built, gathered = [], []
    init, windows = traceback.TextSpans.__init__, traceback.TextSpans.windows

    def counted_init(self, *a, **kw):
        built.append(1)
        init(self, *a, **kw)

    def counted_windows(self, *a, **kw):
        gathered.append(1)
        return windows(self, *a, **kw)

    monkeypatch.setattr(traceback.TextSpans, "__init__", counted_init)
    monkeypatch.setattr(traceback.TextSpans, "windows", counted_windows)
    pats, reads = _inputs("iupac")
    s = _searcher(Searcher, "iupac", {"alpha": 0.5, "max_n_frac": max_n_frac}
                  if max_n_frac else {"alpha": 0.5}, device="cpu")
    plain = traceback.trace_plain.calls
    many = s.search_many(pats[:3], reads, 3)
    single = s.search(pats[0], reads[0], 3)
    assert many and single and traceback.trace_plain.calls > plain
    assert not gathered
    assert bool(built) == (max_n_frac is not None)


def test_finish_split_counts_the_steps():
    pats, reads = _inputs("dna")
    s = Searcher("dna", rc=True, device="cpu").with_max_n_frac(0.2)
    ms = s.search_many(pats, reads, 2)
    sp = s.last_finish_split
    assert sp["matches"] == len(ms) > 0
    assert sp["candidates"] >= sp["kept"] >= sp["windows"] >= len(ms)
    assert all(sp[key] >= 0 for key in ("filters", "gather", "fill", "walk",
                                        "build"))


def test_failed_walk_names_the_candidates_own_text(monkeypatch):
    """A walk that finds no consistent step is walked again on its own
    text's window: the error names that window's byte. Both texts have a
    candidate; only the second's window (the one that starts with G) gets
    a cost no step reaches."""
    pat = b"ACGTACGTTGCA"
    texts = [b"TTTT" + pat + b"TTTT", b"GGGG" + pat[:-1] + b"Z" + b"GG"]
    fill = traceback._fill_batch

    def corrupt(profile, pcodes, wins, *a):
        E, mm = fill(profile, pcodes, wins, *a)  # E: (m + 1, w + 1, B)
        last = E[-1]
        last[:, wins[:, 0] == profile.encode(b"G")[0]] += 50
        return E, mm

    monkeypatch.setattr(traceback, "_fill_batch", corrupt)
    s = Searcher("dna", rc=False, device="cpu")
    with pytest.raises(traceback.TraceError,
                       match="text contains non-dna character 'Z'"):
        s.search_many([pat], texts, 1)


def _pam_check(prof, pam, pam_compl, pam_length, text_up_to_end,
               strand) -> bool:
    """The crispr PAM check one candidate at a time, byte by byte (the
    JAX CLI's filter)."""
    if len(text_up_to_end) < pam_length:
        return False
    tail = text_up_to_end[-pam_length:]
    ref = pam if strand is Strand.FWD else pam_compl
    return all(prof.is_match(int(a), int(b)) for a, b in zip(tail, ref))


@pytest.mark.parametrize("head,pam,pam_length", [
    (b"TGG", b"NGG", 3), (b"TCC", b"NGG", 3), (b"GGA", b"NGG", 3),
    # a guide shorter than --pam-length: its whole self is the PAM, at
    # the start of the last pam_length bytes
    (b"GGA", b"GG", 3), (b"TGG", b"NGG", 5), (b"TGG", b"NGG", 0),
])
def test_pam_filter_equals_the_byte_check(head, pam, pam_length):
    """The CLI's PAM filter, through ``mask_ends`` over a text's ends and
    through its call, equals the byte-by-byte check on each
    ``text[:end]``, on both strands: ends before the PAM fits, at its
    first fit and past the text included."""
    prof = profiles.Iupac()
    pam = np.frombuffer(pam, np.uint8)
    compl = np.frombuffer(prof.complement(pam), np.uint8)
    f = cli._PamFilter(prof, pam, compl, pam_length)
    rng = np.random.default_rng(3)
    text = rng.choice(np.frombuffer(b"ACGTNRY", np.uint8), 400)
    text[:3] = np.frombuffer(head, np.uint8)
    ends = np.arange(0, 405)
    for strand in (Strand.FWD, Strand.RC):
        want = [_pam_check(prof, pam, compl, pam_length,
                           text[: min(e, len(text))], strand) for e in ends]
        np.testing.assert_array_equal(f.mask_ends(text, ends, strand), want)
        assert [f(None, text[:e], strand) for e in ends] == want
        # with --pam-length 0 the tail is the text's start
        assert sum(want) > (10 if pam_length else 1)
    empty = _pam_check(prof, pam, compl, pam_length, text[:0], Strand.FWD)
    assert list(f.mask_ends(text[:0], np.array([0, 3]), Strand.FWD)) == [
        empty, empty]


def test_n_fraction_ok_equals_check_n_fraction():
    """The array N filter equals ``nfilter.check_n_fraction`` region by
    region, bit for bit: regions at and around the float32 threshold,
    empty ones, past the text's end, with and without a denominator."""
    rng = np.random.default_rng(7)
    text = rng.choice(np.frombuffer(b"ACGTNn", np.uint8), 3000)
    text[1000:1400] = ord("N")
    lo = rng.integers(0, 3050, 4000)
    hi = lo + rng.integers(-3, 40, 4000)
    # each region clipped to the text, as the finish gives it
    a = np.minimum(lo, len(text))
    z = np.maximum(a, np.minimum(hi, len(text)))
    count = traceback.TextSpans([text], np.array([len(text)]),
                                np.zeros(4000, np.int64), a,
                                z - a).n_counts(a, z)
    for frac in (0.0, 0.1, 0.25, 1 / 3, 0.5):
        for denom in (None, 23):
            got = nfilter.n_fraction_ok(count, np.minimum(hi, len(text)) - lo,
                                        frac, denom)
            want = [nfilter.check_n_fraction(text, int(s), int(e), frac,
                                             denom)
                    for s, e in zip(lo, hi)]
            np.testing.assert_array_equal(got, want)


def test_is_match_bytes_equals_is_match():
    """The IUPAC profile's byte test over arrays, which the PAM filter
    uses, equals ``is_match`` on every pair of bytes."""
    prof = profiles.Iupac()
    every = np.arange(256, dtype=np.uint8)
    want = np.array([[prof.is_match(a, b) for b in range(256)]
                     for a in range(256)])
    np.testing.assert_array_equal(
        prof.is_match_bytes(every[:, None], every[None, :]), want)


# ---------------------------------------------------------------------
# the Match build


def _per_row_cigars(ops):
    """Each row's Cigar pushed op by op (the scalar walk's construction)."""
    out = []
    for row in ops:
        cigar = Cigar()
        for v in row[row >= 0][::-1].tolist():
            cigar.push("=XDI"[v])
        out.append(cigar)
    return out


def _per_object_matches(without_trace, found, lens, pattern_idx, text_idx):
    """The strands' matches one object at a time, by keywords, sorted by
    pattern, text, strand and candidate rank."""
    rows = sorted(((f, r) for f in found for r in range(len(f.q))),
                  key=lambda fr: (int(fr[0].q[fr[1]]), int(fr[0].t[fr[1]]),
                                  int(fr[0].strand), int(fr[0].seq[fr[1]])))
    out = []
    for f, r in rows:
        rc = f.strand is Strand.RC
        n, te = int(lens[f.t[r]]), int(f.text_end[r])
        at = dict(pattern_idx=int(f.q[r]) + pattern_idx,
                  text_idx=int(f.t[r]) + text_idx,
                  pattern_end=int(f.pattern_end[r]), cost=int(f.cost[r]),
                  strand=f.strand)
        if without_trace:
            out.append(Match(text_start=n - te if rc else UNKNOWN,
                             text_end=UNKNOWN if rc else te,
                             pattern_start=UNKNOWN, **at))
        else:
            ts = int(f.text_start[r])
            out.append(Match(text_start=n - te if rc else ts,
                             text_end=n - ts if rc else te,
                             pattern_start=int(f.pattern_start[r]),
                             cigar=f.cigars[r], **at))
    return out


def _spied(monkeypatch):
    """Record every Match build (its inputs and list) and every CIGAR
    build (its ops rows and Cigars) of the port's Searchers."""
    builds, cigars = [], []
    matches, make_cigars = Searcher._matches, traceback._cigars

    def spy_matches(self, found, lens, pattern_idx=0, text_idx=0):
        out = matches(self, found, lens, pattern_idx, text_idx)
        builds.append((self.without_trace_flag, found, lens, pattern_idx,
                       text_idx, out))
        return out

    def spy_cigars(ops):
        out = make_cigars(ops)
        cigars.append((ops.copy(), out))
        return out

    monkeypatch.setattr(Searcher, "_matches", spy_matches)
    monkeypatch.setattr(traceback, "_cigars", spy_cigars)
    return builds, cigars


#: CASES whose builds are held to the per-object construction, and the
#: single path's search_all over a few reads
BUILD_CASES = ["dna", "dna_fwd", "iupac", "all_minima_filter_fn",
               "only_best", "without_trace", "without_trace_fwd",
               "max_n_frac", "alpha_max_overhang", "n_runs_only_best",
               "single", "single_without_trace"]


@pytest.mark.parametrize("case", BUILD_CASES)
def test_build_equals_per_object_construction(case, monkeypatch):
    builds, cigars = _spied(monkeypatch)
    if case.startswith("single"):
        pats, reads = _inputs("iupac")
        s = _searcher(Searcher, "iupac", {"without_trace": case != "single",
                                          "alpha": 0.5}, device="cpu")
        got = [m for r in reads[:10] for m in s.search_all(pats[0], r, 3)]
        assert len(builds) == 10
    else:
        profile, k, opts, entry, kind = CASES[case]
        pats, reads = _inputs(profile, kind)
        if "alpha" in opts:
            pats = pats[:3]
        got = _call(_searcher(Searcher, profile, opts, device="cpu"), entry,
                    pats, reads, k)
        assert len(builds) == 1
    assert got
    for without_trace, found, lens, pi, ti, out in builds:
        want = _per_object_matches(without_trace, found, lens, pi, ti)
        assert len(out) == len(want)
        assert all(a.same_as(b) for a, b in zip(out, want))
    assert bool(cigars) == ("without_trace" not in case)
    for ops, out in cigars:
        assert out == _per_row_cigars(ops)


@pytest.mark.parametrize("entry", ["search_many", "search_all", "ascii",
                                   "without_trace"])
def test_build_gives_each_match_its_own_objects_and_python_types(entry):
    pats, reads = _inputs("dna")
    if entry == "ascii":
        s = Searcher("ascii", device="cpu")
        got = s.search_many(pats, reads, 2)
    elif entry == "search_all":
        s = Searcher("dna", rc=True, device="cpu")
        got = [m for r in reads[::5] for m in s.search_all(pats[0], r, 2)]
    else:
        s = Searcher("dna", rc=True, device="cpu")
        if entry == "without_trace":
            s.without_trace()
        got = s.search_many(pats, reads, 2)
    assert len(got) > 8
    for m in got:
        for f in ("pattern_idx", "text_idx", "text_start", "text_end",
                  "pattern_start", "pattern_end", "cost"):
            assert type(getattr(m, f)) is int, (f, m)
        assert type(m.strand) is Strand and type(m.cigar) is Cigar
    assert len({id(m.cigar) for m in got}) == len(got)
    assert len({id(m.cigar.ops) for m in got}) == len(got)
    if entry == "without_trace":
        assert not any(m.cigar for m in got)
        return
    # two matches with the same CIGAR: pushing onto one leaves the other
    by_cigar = {}
    for m in got:
        by_cigar.setdefault(m.cigar.to_string(), []).append(m)
    a, b = next(ms for ms in by_cigar.values() if len(ms) > 1)[:2]
    before = b.cigar.to_string()
    a.cigar.push("I")
    a.cigar.push(a.cigar.ops[0][0])
    assert b.cigar.to_string() == before != a.cigar.to_string()
    assert all(m.cigar.to_string() == cig for cig, ms in by_cigar.items()
               for m in ms if m is not a)


#: (entry, profile, Searcher options) of the single path and the ascii
#: profile, against the JAX package's XLA engine
REF_BUILD_CASES = [
    ("search_all", "dna", {}),
    ("search_all", "iupac", {"alpha": 0.5, "only_best": True}),
    ("search_all", "iupac", {"without_trace": True}),
    ("search_all", "iupac", {"max_n_frac": 0.2}),
    ("search_all", "ascii", {"rc": False}),
    ("search_many", "ascii", {"rc": False}),
    ("search_many", "ascii", {"rc": False, "without_trace": True}),
]


@pytest.mark.parametrize("entry,profile,opts", REF_BUILD_CASES)
def test_build_equals_reference_on_the_single_path_and_ascii(entry, profile,
                                                              opts):
    pats, reads = _inputs("dna" if profile == "ascii" else profile)
    reads = reads[:10]

    def run(s):
        if entry == "search_many":
            return s.search_many(pats, reads, 2)
        return [m for r in reads[::2] for m in s.search_all(pats[0], r, 2)]

    got = run(_searcher(Searcher, profile, opts, device="cpu"))
    assert got
    _same(got, run(_searcher(RefSearcher, profile, opts, engine="xla")))


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("fails", [False, True])
def test_build_restores_the_collectors_state(enabled, fails, monkeypatch):
    """The collector's state after a call is the one before it, also
    after a TraceError; the build never runs ``gc.collect``."""

    def no_collect(*a):
        raise AssertionError("the build ran gc.collect")

    monkeypatch.setattr(gc, "collect", no_collect)
    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        seen = []
        paused = collector.paused

        def watched(split=None):
            seen.append(gc.isenabled())
            return paused(split)

        monkeypatch.setattr(collector, "paused", watched)
        pat = b"ACGTACGTTGCA"
        texts = [b"TTTT" + pat + b"TTTT", b"GGGG" + pat[:-1] + b"Z" + b"GG"]
        s = Searcher("dna", rc=False, device="cpu")
        if fails:
            fill = traceback._fill_batch

            def corrupt(profile, pcodes, wins, *a):
                E, mm = fill(profile, pcodes, wins, *a)
                E[-1] += 50
                return E, mm

            monkeypatch.setattr(traceback, "_fill_batch", corrupt)
            with pytest.raises(traceback.TraceError):
                s.search_many([pat], texts, 1)
        else:
            assert s.search_many([pat], texts, 1)
        assert seen and gc.isenabled() is enabled
    finally:
        (gc.enable if was else gc.disable)()


def test_overlapping_builds_hold_the_collector_off_until_the_last_leaves():
    """Two threads' builds: the collector stays off while either holds it
    and comes back on when the last one leaves; passes that run in a
    build anyway are counted into its split."""
    was = gc.isenabled()
    gc.enable()
    try:
        inside, release = threading.Event(), threading.Event()

        def other():
            with collector.paused():
                inside.set()
                release.wait(10)

        th = threading.Thread(target=other)
        th.start()
        assert inside.wait(10)
        split = {}
        with collector.paused(split):
            assert not gc.isenabled()
            gc.collect()
        assert not gc.isenabled()  # the other build holds it still
        assert split["gc_passes"] >= 1 and split["gc_s"] > 0
        release.set()
        th.join(10)
        assert gc.isenabled()
        assert gc.callbacks.count(collector._on_pass) == 0
    finally:
        release.set()
        (gc.enable if was else gc.disable)()


@pytest.mark.parametrize("entry", ["search_many", "search_all"])
def test_build_split_sums_to_build(entry):
    pats, reads = _inputs("dna")
    s = Searcher("dna", rc=True, device="cpu")
    if entry == "search_many":
        ms = s.search_many(pats, reads, 2)  # two lengths, two strands
    else:
        ms = s.search_all(pats[0], reads[0], 2)
    sp = s.last_finish_split
    assert ms and sp["matches"] == len(ms)
    parts = sp["unpack"] + sp["cigars"] + sp["match_objects"]
    assert parts == pytest.approx(sp["build"], rel=1e-9, abs=1e-12)
    assert min(sp["unpack"], sp["cigars"], sp["match_objects"]) > 0
    assert sp["gc_passes"] == 0 and sp["gc_s"] == 0


def test_many_threads_building_at_once_keep_the_collector_consistent():
    """More threads than cores enter and leave builds with a short switch
    interval: inside every build the collector is off, and after the last
    it is on again with the pass counter removed."""
    import os
    import sys

    was, interval = gc.isenabled(), sys.getswitchinterval()
    gc.enable()
    sys.setswitchinterval(1e-6)
    on_inside = []

    def builds():
        for _ in range(300):
            with collector.paused({}):
                if gc.isenabled():
                    on_inside.append(1)

    try:
        threads = [threading.Thread(target=builds)
                   for _ in range((os.cpu_count() or 1) + 4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
        assert not on_inside and gc.isenabled() and collector._held == 0
        assert gc.callbacks.count(collector._on_pass) == 0
    finally:
        sys.setswitchinterval(interval)
        (gc.enable if was else gc.disable)()


@pytest.mark.parametrize("B,step", [(0, 5), (3, 0), (1, 1), (500, 9),
                                    (2000, 52)])
def test_cigars_equal_per_row_construction(B, step):
    """Walk-order ops rows (a prefix of codes, -1 past it; some rows with
    no op, many repeated) give the Cigars pushed op by op, each its own
    object."""
    rng = np.random.default_rng(B + step)
    lens = rng.integers(0, step + 1, B)
    ops = np.where(np.arange(step) < lens[:, None],
                   rng.choice(4, (B, step), p=[0.7, 0.1, 0.1, 0.1]),
                   -1).astype(np.int8)
    ops[: B // 2] = ops[B // 4 : B // 4 + B // 2]  # repeated rows
    got = traceback._cigars(ops)
    assert got == _per_row_cigars(ops)
    assert len({id(c) for c in got}) == len({id(c.ops) for c in got}) == B
