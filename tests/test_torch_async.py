"""The single engine's ``candidates_async`` and its prepared-text cache, on
the CPU (the kernels' plain versions), against ``candidates`` and the JAX
package's ``XlaEngine.candidates_async``; and the engines' default device,
"cuda", which raises without a card."""

import gc
import threading

import numpy as np
import pytest
import torch

from sassy_tpu import profiles as ref_profiles
from sassy_tpu.ops.myers_xla import XlaEngine
from sassy_tpu_torch import Searcher, profiles
from sassy_tpu_torch.ops import batch, myers_torch, plan
from sassy_tpu_torch.ops.myers_torch import PreparedText, TorchEngine

BASES = np.frombuffer(b"ACGT", np.uint8)


def _planted(seed, n, m, hang=0):
    """Random ACGT with the pattern at a few interior offsets (one copy
    with a substitution) and, with ``hang``, hanging off both ends."""
    rng = np.random.default_rng(seed)
    text = rng.choice(BASES, n)
    pat = rng.choice(BASES, m)
    mut = pat.copy()
    mut[m // 2] = b"C"[0] if mut[m // 2] != b"C"[0] else b"G"[0]
    for off, what in ((n // 5, pat), (n // 2, mut), (3 * n // 4, pat)):
        text[off : off + m] = what
    if hang:
        text[: m - hang] = pat[hang:]
        text[n - (m - hang) :] = pat[: m - hang]
    return text, pat


#: (profile, m, k, alpha, n, the path it takes)
SHAPES = {
    "word_level": ("dna", 23, 3, None, 6000),
    "tail_tile": ("iupac", 23, 3, 0.5, 6000),
    "position_level": ("iupac", 110, 10, 0.1, 2500),
    "prefilter": ("iupac", 80, 3, None, 9000),
}


@pytest.mark.parametrize("all_minima", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_candidates_async_equals_candidates_and_reference(shape, all_minima,
                                                          monkeypatch):
    name, m, k, alpha, n = SHAPES[shape]
    text, pat = _planted(len(shape), n, m, hang=4 if alpha else 0)
    prof = profiles.get_profile(name)
    ref_prof = ref_profiles.get_profile(name)
    codes = prof.encode(pat)
    if shape == "prefilter":
        monkeypatch.setattr(plan, "HIER_MIN_SAVED_PAIRS", 0)
    eng = TorchEngine("cpu")
    inp = eng.build_inputs(prof, codes, text, k, alpha, None, all_minima)
    assert inp.fast == (shape != "position_level")
    assert bool(inp.n_prev) == (shape == "tail_tile")
    assert bool(inp.hier_s) == (shape == "prefilter")
    got = eng.candidates_async(prof, codes, text, k, alpha, None,
                               all_minima)()
    assert got == eng.candidates(prof, codes, text, k, alpha, None,
                                 all_minima)
    want = XlaEngine().candidates_async(ref_prof, ref_prof.encode(pat), text,
                                        k, alpha, None, all_minima)()
    assert got == sorted(want) and len(got) >= 3


def test_candidates_async_returns_while_the_dispatch_thread_is_held(
        monkeypatch):
    """The device work runs on the dispatch thread: the call returns while
    that thread is busy, and ``finish()`` waits for the work."""
    text, pat = _planted(1, 3000, 23)
    prof = profiles.Dna()
    codes = prof.encode(pat)
    eng = TorchEngine("cpu")
    want = eng.candidates(prof, codes, text, 2, None, None, False)
    ran_on = []
    build = eng.build_inputs

    def spy(*args, **kw):
        ran_on.append(threading.current_thread().name)
        return build(*args, **kw)

    monkeypatch.setattr(eng, "build_inputs", spy)
    release = threading.Event()
    blocker = myers_torch._worker().submit(release.wait, 30)
    try:
        finish = eng.candidates_async(prof, codes, text, 2, None, None, False)
        assert ran_on == []  # returned before its dispatch began
    finally:
        release.set()
    assert blocker.result(timeout=30)
    assert finish() == want and want
    assert ran_on[0].startswith("sassy_tpu_torch-dispatch")


def test_two_searches_in_flight_finish_in_reverse_order():
    prof = profiles.Dna()
    t1, p1 = _planted(2, 4000, 23)
    t2, p2 = _planted(3, 5000, 30)
    eng = TorchEngine("cpu")
    w1 = eng.candidates(prof, prof.encode(p1), t1, 3, None, None, False)
    w2 = eng.candidates(prof, prof.encode(p2), t2, 2, None, None, True)
    f1 = eng.candidates_async(prof, prof.encode(p1), t1, 3, None, None, False)
    f2 = eng.candidates_async(prof, prof.encode(p2), t2, 2, None, None, True)
    assert f2() == w2 and f1() == w1 and w1 != w2


def test_dispatch_errors_are_raised_by_finish():
    prof = profiles.Iupac()
    eng = TorchEngine("cpu")
    # an overshoot longer than the reserved tail raises in build_inputs
    finish = eng.candidates_async(prof, prof.encode(b"ACGT" * 700),
                                  np.frombuffer(b"ACGT" * 50, np.uint8), 50,
                                  0.01, None, False)
    with pytest.raises(ValueError, match="overhang of"):
        finish()


def _frozen(a):
    a.flags.writeable = False
    return a


def test_prepare_cache_reuses_and_frees():
    """The same read-only array gives the same PreparedText (per profile
    and case sensitivity); its entry goes with the array; at most 8 are
    kept."""
    eng = TorchEngine("cpu")
    dna, iupac = profiles.Dna(), profiles.Iupac()
    text = _frozen(np.frombuffer(b"ACGTTGCAAC" * 40, np.uint8).copy())
    prep = eng.prepare(dna, text)
    assert eng.prepare(dna, text) is prep
    assert eng.prepare(iupac, text) is not prep
    sens, insens = profiles.Ascii(), profiles.Ascii(case_sensitive=False)
    assert eng.prepare(sens, text) is not eng.prepare(insens, text)
    assert len(eng._prep_cache) == 4
    del text, prep
    gc.collect()
    assert len(eng._prep_cache) == 0
    keep = [_frozen(np.zeros(64, np.uint8)) for _ in range(10)]
    preps = [eng.prepare(dna, t) for t in keep]
    assert len(eng._prep_cache) == 8
    assert eng.prepare(dna, keep[-1]) is preps[-1]
    assert eng.prepare(dna, keep[0]) is not preps[0]  # evicted first


def test_reverse_strand_views_leave_no_cache_entry(monkeypatch):
    """A two-strand search prepares both strands from one upload, as one
    pair cached under the forward array: the pair is made once, on the
    first search; no entry is keyed by a short-lived view (the reversed
    text); a second search over the same array makes no PreparedText and
    uploads nothing."""
    made = []
    init = PreparedText.__init__

    def counting(self, profile, text, device, reverse=False):
        made.append((len(text), reverse))
        init(self, profile, text, device, reverse)

    monkeypatch.setattr(PreparedText, "__init__", counting)
    uploads = []
    upload = myers_torch._upload
    monkeypatch.setattr(myers_torch, "_upload",
                        lambda t, d: uploads.append(len(t)) or upload(t, d))
    text, pat = _planted(4, 3000, 23)
    text = np.frombuffer(text.tobytes(), np.uint8)  # read-only, over bytes
    s = Searcher("dna", rc=True, device="cpu")
    first = s.search(pat, text, 2)
    assert made == [(3000, False), (3000, True)] and uploads == [3000]
    keys = list(s.engine._prep_cache._items)
    assert len(keys) == 1 and keys[0][0] == id(text) and keys[0][-1] == 2
    assert [m.sort_key() for m in s.search(pat, text, 2)] == [
        m.sort_key() for m in first]
    assert len(made) == 2 and uploads == [3000]
    assert list(s.engine._prep_cache._items) == keys


@pytest.mark.parametrize("make", [
    lambda: TorchEngine(),
    lambda: batch.BatchEngine(),
    lambda: batch.TextSet([b"ACGT"]),
    lambda: Searcher("dna"),
])
def test_engines_default_to_cuda_and_raise_without_a_card(make,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert make().device == torch.device("cuda")


def test_prepare_cache_under_threads():
    """Puts, gets and sources dying on many threads at once (as the
    weakref callbacks run on whichever thread drops a source): the cache
    never exceeds its bound, a get returns only its own source's entry,
    and nothing is left once the sources are gone."""
    import sys

    cache = myers_torch._IdCache()
    dna = profiles.Dna()
    errors, sizes = [], []

    def work(seed):
        try:
            for i in range(300):
                src = _frozen(np.zeros(8, np.uint8))
                prep = (seed, i)
                cache.put(dna, src, prep)
                got = cache.get(dna, src)
                if got not in (None, prep):
                    errors.append((seed, i, got))
                sizes.append(len(cache))
                del src
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert max(sizes) <= cache.max_items
    gc.collect()
    assert len(cache) == 0


def test_only_arrays_that_cannot_change_are_cached():
    frozen = myers_torch._IdCache.frozen
    over_bytes = np.frombuffer(b"ACGTACGT", np.uint8)
    assert frozen(over_bytes) and frozen(over_bytes[2:6]) and frozen(
        over_bytes[::-1])
    assert frozen(_frozen(np.zeros(4, np.uint8)))
    writeable = np.zeros(8, np.uint8)
    view = writeable[2:]
    view.flags.writeable = False  # still changes through its base
    assert not frozen(writeable) and not frozen(view)
    assert not frozen(np.frombuffer(bytearray(b"ACGT"), np.uint8))
    assert not frozen(torch.zeros(4, dtype=torch.uint8))
    assert not frozen(b"ACGT")


def test_an_array_changed_in_place_is_searched_anew():
    """A writeable text changed between two searches: the second finds the
    new copies, on the forward strand and on the reverse (a cache keyed by
    identity alone would return the old text's candidates)."""
    text, pat = _planted(5, 4000, 23)
    rc = np.frombuffer(profiles.Dna().reverse_complement(pat), np.uint8)
    s = Searcher("dna", rc=True, device="cpu")
    first = {(m.strand.name, m.text_start) for m in s.search(pat, text, 1)}
    assert ("FWD", 1000) not in first and ("RC", 2000) not in first
    text[1000:1023] = pat
    text[2000:2023] = rc
    again = s.search(pat, text, 1)
    assert {("FWD", 1000), ("RC", 2000)} <= {
        (m.strand.name, m.text_start) for m in again}
    assert len(s.engine._prep_cache) == 0
