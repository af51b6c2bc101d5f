"""Both strands of one text from one upload, on the CPU (the kernels' plain
versions), against the JAX package.

``TorchEngine.prepare_strands`` uploads a text's bytes once and packs
both strands from them: the forward strand with the pack
(``myers_torch.pack``), the reverse strand with the text set's pack of a
one-text set read backwards (``myers_torch.pack_backwards``, which is
``batch.pack_set``; ``pack_set_plain`` here, the kernel on the card). A
``PreparedText`` of a reversed view takes the same path from the view's
forward bytes. Here:

- the reverse strand's planes equal the JAX package's jitted ``pack``
  (``sassy_tpu/ops/myers_xla.py:172``) of the reversed text, bit for bit,
  at the port's plane width, and the forward strand's its pack of the
  text, for DNA and IUPAC, texts of 0, 1, 31, 32, 33 and random lengths
  of every byte value;
- a two-strand ``Searcher("dna" / "iupac", rc=True, device="cpu")``
  search uploads each text once and returns the Match list, CIGARs
  included, of ``sassy_tpu.Searcher(engine="xla")``, for ``search``,
  ``search_all`` and ``search_with_fn``, with and without overhang;
- a second search of a read-only array prepares and uploads nothing;
  a writeable one is prepared anew each time, both strands.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sassy_tpu import Searcher as RefSearcher
from sassy_tpu import profiles as ref_profiles
from sassy_tpu.ops import myers_xla
from sassy_tpu_torch import Searcher, profiles
from sassy_tpu_torch.ops import batch, myers_torch
from sassy_tpu_torch.ops.myers_torch import PreparedText, TorchEngine

PROFILES = {
    "dna": (profiles.Dna(), ref_profiles.Dna()),
    "iupac": (profiles.Iupac(), ref_profiles.Iupac()),
}

LENGTHS = [0, 1, 31, 32, 33, 64, 95, 1000, 4133]

BASES = np.frombuffer(b"ACGT", np.uint8)


def _jax_pack(ref_prof, text: np.ndarray, gw: int) -> np.ndarray:
    """The JAX package's jitted pack of ``text`` at ``gw`` words, as
    int32."""
    n = len(text)
    buf = np.zeros(gw * 32, np.uint8)
    buf[:n] = text
    got = myers_xla._kernels()["pack_jit"](
        jnp.asarray(buf), np.int32(n // 32), np.int32(n % 32),
        planes=ref_prof.planes, with_valid=ref_prof.eq_mode == "ascii",
        mode=ref_prof.pack_mode, shift=ref_prof.pack_shift,
        mask=ref_prof.pack_mask, pmasks=tuple(ref_prof.pack_plane_masks),
        fold=ref_prof.pack_fold_case)
    return np.asarray(got).view(np.int32)


class _Uploads:
    """Counts the host texts ``myers_torch._upload`` sends and the packs
    of each kind: ``packs`` is (``myers_torch.pack`` calls, the forward
    strand's; ``batch.pack_set`` calls, the reverse strand's)."""

    def __init__(self, monkeypatch):
        self.sizes = []
        self.packs = [0, 0]
        for i, (mod, name) in enumerate(((myers_torch, "_upload"),
                                         (myers_torch, "pack"),
                                         (batch, "pack_set"))):
            monkeypatch.setattr(mod, name, self._counting(
                getattr(mod, name), i))

    def _counting(self, fn, i):
        def counted(*args, **kw):
            if i == 0:
                self.sizes.append(len(args[0]))
            else:
                self.packs[i - 1] += 1
            return fn(*args, **kw)

        return counted


@pytest.mark.parametrize("n", LENGTHS + ["random"])
@pytest.mark.parametrize("name", sorted(PROFILES))
def test_reverse_strand_planes_equal_jax_pack_of_reversed_text(
        name, n, monkeypatch):
    """One upload; the reverse strand's planes are the JAX pack of the
    reversed bytes, the forward strand's of the bytes (every byte value),
    each strand one pack of its own kind; a ``PreparedText`` of the
    reversed view packs the same planes from the forward bytes."""
    prof, ref_prof = PROFILES[name]
    rng = np.random.default_rng(LENGTHS.index(n) if n != "random" else 99)
    if n == "random":
        n = int(rng.integers(1, 3000))
    text = rng.integers(0, 256, n, dtype=np.uint8)
    uploads = _Uploads(monkeypatch)
    fwd, rev = TorchEngine("cpu").prepare_strands(prof, text)
    assert uploads.sizes == [n] and uploads.packs == [1, 1]
    assert fwd.n == rev.n == n and fwd.gw == rev.gw
    np.testing.assert_array_equal(rev.planes.numpy(),
                                  _jax_pack(ref_prof, text[::-1], rev.gw))
    np.testing.assert_array_equal(fwd.planes.numpy(),
                                  _jax_pack(ref_prof, text, fwd.gw))
    view = PreparedText(prof, text[::-1], "cpu")
    assert uploads.sizes == [n, n]
    assert torch.equal(view.planes, rev.planes)


def _planted(seed: int, n: int, m: int, iupac: bool):
    """Random ACGT (with a few IUPAC codes for iupac) and a pattern planted
    on both strands, exact and with one substitution, and hanging off
    both ends."""
    rng = np.random.default_rng(seed)
    text = rng.choice(BASES, n)
    if iupac:
        text[rng.integers(0, n, 20)] = np.frombuffer(b"N", np.uint8)
    pat = rng.choice(BASES, m)
    rc = np.frombuffer(profiles.Dna().reverse_complement(pat), np.uint8)
    mut = pat.copy()
    mut[m // 2] = b"C"[0] if mut[m // 2] != b"C"[0] else b"G"[0]
    for off, what in ((n // 5, pat), (n // 3, rc), (n // 2, mut),
                      (3 * n // 4, rc[::-1].copy())):
        text[off : off + m] = what
    text[: m - 4] = pat[4:]
    text[n - (m - 4):] = rc[: m - 4]
    return text, pat


def _key(m):
    return m.sort_key(), m.cigar.to_string() if m.cigar else None


#: (profile, pattern length, k, alpha)
SEARCHES = [("dna", 23, 3, None), ("iupac", 23, 3, None),
            ("iupac", 23, 3, 0.5), ("iupac", 40, 6, 0.1)]


@pytest.mark.parametrize("method", ["search", "search_all",
                                    "search_with_fn"])
@pytest.mark.parametrize("case", range(len(SEARCHES)))
def test_two_strand_search_uploads_once_and_equals_xla(case, method,
                                                       monkeypatch):
    """Each two-strand search uploads its text once (a writeable array,
    so every search prepares anew) and returns the XLA engine's Match
    list, CIGARs included."""
    name, m, k, alpha = SEARCHES[case]
    text, pat = _planted(case, 5000, m, name == "iupac")
    port = Searcher(name, rc=True, alpha=alpha, device="cpu")
    ref = RefSearcher(name, rc=True, alpha=alpha, engine="xla")
    uploads = _Uploads(monkeypatch)
    if method == "search_with_fn":
        def keep(p, t, strand):  # ends past the text's first fifth
            return len(t) > 1000

        got = port.search_with_fn(pat, text, k, True, keep)
        want = ref.search_with_fn(pat, text, k, True, keep)
    else:
        got = getattr(port, method)(pat, text, k)
        want = getattr(ref, method)(pat, text, k)
    assert uploads.sizes == [len(text)]
    assert [_key(x) for x in got] == [_key(x) for x in want]
    assert {x.strand.name for x in got} == {"FWD", "RC"}
    assert len(port.engine._prep_cache) == 0  # writeable: not kept


def test_second_search_of_a_read_only_array_prepares_nothing(monkeypatch):
    """A read-only array (over bytes) searched twice on both strands: the
    first search uploads once and packs each strand once; the second
    uploads and packs nothing and returns the same Match list; a
    one-strand search then reuses the pair's forward strand."""
    text, pat = _planted(7, 6000, 23, False)
    text = np.frombuffer(text.tobytes(), np.uint8)
    s = Searcher("dna", rc=True, device="cpu")
    uploads = _Uploads(monkeypatch)
    first = s.search(pat, text, 2)
    assert uploads.sizes == [len(text)] and uploads.packs == [1, 1]
    again = s.search(pat, text, 2)
    assert uploads.sizes == [len(text)] and uploads.packs == [1, 1]
    assert [_key(x) for x in again] == [_key(x) for x in first] and first
    fwd_only = Searcher("dna", device="cpu")
    fwd_only.engine = s.engine
    assert [_key(x) for x in fwd_only.search(pat, text, 2)] == [
        _key(x) for x in first if x.strand.name == "FWD"]
    assert uploads.sizes == [len(text)] and uploads.packs == [1, 1]


def test_changed_writeable_array_is_prepared_anew_on_both_strands():
    """A writeable text changed in place between two-strand searches: the
    second search finds the new copies on both strands."""
    text, pat = _planted(9, 4000, 23, False)
    rc = np.frombuffer(profiles.Dna().reverse_complement(pat), np.uint8)
    s = Searcher("dna", rc=True, device="cpu")
    first = {(x.strand.name, x.text_start) for x in s.search(pat, text, 0)}
    assert ("FWD", 1500) not in first and ("RC", 2500) not in first
    text[1500:1523] = pat
    text[2500:2523] = rc
    again = {(x.strand.name, x.text_start) for x in s.search(pat, text, 0)}
    assert {("FWD", 1500), ("RC", 2500)} <= again
    assert len(s.engine._prep_cache) == 0
