"""The port's :class:`Searcher`: the public API of ``sassy_tpu.Searcher``
(reference sassy src/search.rs:358-784) on the PyTorch/CUDA engines.

``search``, ``search_all``, ``search_with_fn``, ``search_texts``,
``search_patterns``, ``search_many``, ``search_many_with_fn(_async)``, the
encoded-pattern API and ``search_all_alignments``, with reverse
complement, overhang (``alpha``, ``max_overhang``), ``only_best_match``,
``without_trace`` and ``max_n_frac``. Two engines find the candidates on
``device``: ``TorchEngine`` (one pattern, one text) and ``BatchEngine``
(patterns x texts). The end-position filter, the N-fraction filter,
only-best selection and the CIGAR traceback run on the host, as in the
reference, from the port's own copies of its host modules.

Reverse-complement handling follows the reference exactly (search.rs:
787-881): search the *complemented* pattern against the *reversed* text,
then map positions back to forward coordinates (``text_start = len -
rc_end``), keeping the CIGAR in pattern direction.
"""

from __future__ import annotations

import numpy as np
import torch

from .matchrec import UNKNOWN, Match, Strand
from .nfilter import satisfy_n_endpoint_filter, traced_satisfy_n_frac
from .ops.batch import BatchEngine, TextSet
from .ops.myers_torch import TorchEngine
from .profiles import Profile, as_bytes_array, get_profile
from .traceback import trace_candidates_batch

__all__ = ["Searcher", "CachedRev", "EncodedPatterns", "SearchMode"]


class EncodedPatterns:
    """A pre-validated batch of equal-length patterns for repeated batched
    searching (the reference's v2 ``EncodedPatterns``, general.rs:133-196).
    ``rc_anchor`` "start" (the default, the v2 engine's semantics) searches
    RC(pattern) on the forward text; "end" (v1) searches the pattern on the
    reversed text."""

    def __init__(self, profile, patterns, include_rc: bool,
                 rc_anchor: str = "start"):
        self.patterns = [as_bytes_array(p) for p in patterns]
        lens = {len(p) for p in self.patterns}
        if len(lens) > 1:
            raise ValueError("encode_patterns requires equal-length patterns")
        self.pattern_len = lens.pop() if lens else 0
        self.include_rc = include_rc
        self.profile = profile
        if rc_anchor not in ("end", "start"):
            raise ValueError("rc_anchor must be 'end' or 'start'")
        self.rc_anchor = rc_anchor

    @property
    def n_original(self) -> int:
        return len(self.patterns)


class SearchMode:
    """Batching strategies for :meth:`Searcher.search_many` (reference
    search.rs:317-344): accepted for API compatibility; the batched engine
    batches patterns and texts together."""

    SINGLE = "single"
    BATCH_PATTERNS = "batch_patterns"
    BATCH_TEXTS = "batch_texts"
    BATCH_PATTERNS_SHORT = "batch_patterns_short"
    AUTO = "auto"


class CachedRev:
    """Text wrapper that precomputes the reversed text once (reference
    search.rs:144-166): *reversed*, not reverse-complemented — RC search
    complements the pattern instead."""

    def __init__(self, text, cache: bool = True):
        self.fwd = as_bytes_array(text)
        self._rev = self.fwd[::-1].copy() if cache else None

    def text(self) -> np.ndarray:
        return self.fwd

    def rev_text(self) -> np.ndarray:
        if self._rev is None:
            return self.fwd[::-1]
        return self._rev


def _as_rc_searchable(text) -> CachedRev:
    if isinstance(text, CachedRev):
        return text
    return CachedRev(text, cache=False)


class Searcher:
    """Approximate string searcher on a PyTorch device.

    Args:
        profile: ``Dna()``, ``Iupac()``, ``Ascii()`` or their names (the
            name "ascii" also turns ``rc`` off).
        rc: also search the reverse-complement strand.
        alpha: overhang cost per char, in [0, 1] (a profile with
            ``supports_overhang``: Iupac).
        device: "cuda" runs the hand-written scan kernels (and raises
            without a CUDA device); "cpu" runs their plain PyTorch versions.
        max_n_frac: N-fraction filter, as in the reference.
    """

    def __init__(self, profile: Profile | str, rc: bool = False,
                 alpha: float | None = None, device="cuda",
                 max_n_frac: float | None = None):
        if isinstance(profile, str):
            # string alphabets as in the reference Python binding
            # (python.rs:27-63); ascii has no reverse complement, so rc is
            # forced off (python.rs:41)
            profile = get_profile(profile)
            if profile.name == "ascii":
                rc = False
        if alpha is not None:
            self._overhang_check(profile, alpha)
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Searcher(device='cuda'): no CUDA device")
        self.profile = profile
        self.rc = rc
        self.alpha = alpha
        self.only_best_match_flag = False
        self.without_trace_flag = False
        self.max_overhang: int | None = None
        self.max_n_frac: float | None = None
        if max_n_frac is not None:
            self.set_max_n_frac(max_n_frac)
        self.device = device
        self.engine = TorchEngine(device)
        self.batch = BatchEngine(device)

    # ------------------------------------------------------------------
    # builders (reference search.rs:364-483)

    @staticmethod
    def new_fwd(profile: Profile, **kw) -> "Searcher":
        return Searcher(profile, rc=False, **kw)

    @staticmethod
    def new_rc(profile: Profile, **kw) -> "Searcher":
        return Searcher(profile, rc=True, **kw)

    @staticmethod
    def new_fwd_with_overhang(profile: Profile, alpha: float,
                              **kw) -> "Searcher":
        return Searcher(profile, rc=False, alpha=alpha, **kw)

    @staticmethod
    def new_rc_with_overhang(profile: Profile, alpha: float,
                             **kw) -> "Searcher":
        return Searcher(profile, rc=True, alpha=alpha, **kw)

    @staticmethod
    def _overhang_check(profile: Profile, alpha: float) -> None:
        if not profile.supports_overhang:
            raise ValueError(
                f"overhang is not supported for profile {profile.name!r}")
        if not (0.0 <= alpha <= 1.0):
            raise ValueError("alpha must be in range 0.0 <= alpha <= 1.0")

    def with_overhang(self, alpha: float) -> "Searcher":
        self._overhang_check(self.profile, alpha)
        self.alpha = alpha
        return self

    def with_max_overhang(self, max_overhang: int | None) -> "Searcher":
        self.max_overhang = max_overhang
        return self

    def only_best_match(self) -> "Searcher":
        self.only_best_match_flag = True
        return self

    def without_trace(self) -> "Searcher":
        self.without_trace_flag = True
        return self

    def with_trace(self) -> "Searcher":
        self.without_trace_flag = False
        return self

    def set_trace(self, trace: bool) -> None:
        self.without_trace_flag = not trace

    def set_max_n_frac(self, max_n_frac: float) -> None:
        # 1.0 disables (reference search.rs:454-460)
        self.max_n_frac = None if max_n_frac == 1.0 else max_n_frac

    def with_max_n_frac(self, max_n_frac: float) -> "Searcher":
        self.set_max_n_frac(max_n_frac)
        return self

    def without_max_n_frac(self) -> "Searcher":
        self.max_n_frac = None
        return self

    # ------------------------------------------------------------------
    # single pattern, single text

    def search(self, pattern, text, k: int) -> list[Match]:
        """Matches at rightmost-local-minimum end positions with cost <= k."""
        return self._search_handle_rc(pattern, text, k, all_minima=False)

    def search_all(self, pattern, text, k: int) -> list[Match]:
        """Matches at *all* end positions with cost <= k."""
        return self._search_handle_rc(pattern, text, k, all_minima=True)

    def search_with_fn(self, pattern, text, k: int, all_minima: bool,
                       filter_fn) -> list[Match]:
        """Like search/search_all with an end-position filter
        ``filter_fn(pattern, text_up_to_end, strand)``; for RC searches both
        are complemented/reversed, as in the reference (search.rs:756-784)."""
        return self._search_handle_rc(pattern, text, k, all_minima,
                                      filter_fn=filter_fn)

    # ------------------------------------------------------------------
    # batched: patterns x texts on the batched engine

    def search_texts(self, pattern, texts, k: int) -> list[Match]:
        """One pattern against multiple texts; ``text_idx`` set per text."""
        return self._search_many_impl([pattern], texts, k, False)

    def search_all_texts(self, pattern, texts, k: int) -> list[Match]:
        return self._search_many_impl([pattern], texts, k, True)

    def search_patterns(self, patterns, text, k: int) -> list[Match]:
        """Multiple equal-length patterns against one text."""
        lens = {len(as_bytes_array(p)) for p in patterns}
        if len(lens) > 1:
            raise ValueError("search_patterns requires equal-length patterns")
        return self._search_many_impl(patterns, [text], k, False)

    def search_many(self, patterns, texts, k: int, num_threads: int = 0,
                    mode: str = SearchMode.AUTO) -> list[Match]:
        """Cartesian product search (reference search.rs:531-603), in
        (pattern-major, text-minor) order; ``num_threads``/``mode`` are
        accepted for API compatibility."""
        del num_threads, mode
        return self._search_many_impl(patterns, texts, k, False)

    def search_many_with_fn(self, patterns, texts, k: int, all_minima: bool,
                            filter_fn) -> list[Match]:
        """The batched counterpart of search_with_fn: one device pass for
        the whole product, the filter on the candidates."""
        return self._search_many_impl(patterns, texts, k, all_minima,
                                      filter_fn=filter_fn)

    def search_many_with_fn_async(self, patterns, texts, k: int,
                                  all_minima: bool, filter_fn):
        """search_many_with_fn, split into dispatch-now / finish-later:
        returns a ``finish()`` callable. The device work runs on the batched
        engine's dispatch thread meanwhile."""
        return self._search_many_batched_async(
            [as_bytes_array(p) for p in patterns],
            [_as_rc_searchable(t) for t in texts],
            k, all_minima, self.rc, filter_fn,
        )

    def encode_patterns(self, patterns, include_rc: bool | None = None,
                        rc_anchor: str = "start"):
        """Pre-encode a batch of equal-length patterns for repeated use
        (see EncodedPatterns.rc_anchor)."""
        return EncodedPatterns(
            self.profile, patterns,
            include_rc if include_rc is not None else self.rc,
            rc_anchor=rc_anchor,
        )

    def search_encoded_patterns(self, encoded, text, k: int) -> list[Match]:
        if encoded.rc_anchor == "start":
            return self._search_encoded_v2_anchor(encoded, text, k, False)
        return self._search_many_impl(encoded.patterns, [text], k, False,
                                      rc=encoded.include_rc)

    def search_all_encoded_patterns(self, encoded, text,
                                    k: int) -> list[Match]:
        if encoded.rc_anchor == "start":
            return self._search_encoded_v2_anchor(encoded, text, k, True)
        return self._search_many_impl(encoded.patterns, [text], k, True,
                                      rc=encoded.include_rc)

    def _search_encoded_v2_anchor(self, encoded, text, k: int,
                                  all_minima: bool) -> list[Match]:
        """v2 RC anchor semantics (reference lib.rs:33-40): RC(pattern) is
        one more forward pattern of the same batch, and its matches are
        relabelled as RC ones."""
        pats = encoded.patterns
        if not encoded.include_rc:
            return self._search_many_impl(pats, [text], k, all_minima,
                                          rc=False)
        prof = self.profile
        Q = len(pats)
        rc_pats = [as_bytes_array(prof.reverse_complement(p)) for p in pats]
        ms_all = self._search_many_impl(pats + rc_pats, [text], k,
                                        all_minima, rc=False)
        m_len = encoded.pattern_len
        for m in ms_all:
            if m.pattern_idx >= Q:
                m.pattern_idx -= Q
                m.strand = Strand.RC
                if m.cigar is not None:
                    m.cigar = m.cigar.reversed()
                if m.pattern_start is not UNKNOWN:
                    ps, pe = m.pattern_start, m.pattern_end
                    m.pattern_start, m.pattern_end = m_len - pe, m_len - ps
        return ms_all

    def search_all_alignments(self, pattern, text,
                              k: int) -> list[list[Match]]:
        from .alignment_iterator import search_all_alignments

        return search_all_alignments(self, pattern, text, k)

    def _search_many_impl(self, patterns, texts, k: int, all_minima: bool,
                          rc: bool | None = None,
                          filter_fn=None) -> list[Match]:
        return self._search_many_batched_async(
            [as_bytes_array(p) for p in patterns],
            [_as_rc_searchable(t) for t in texts],
            k, all_minima, self.rc if rc is None else rc, filter_fn,
        )()

    def _search_many_batched_async(self, pats, rc_texts, k: int,
                                   all_minima: bool, rc: bool,
                                   filter_fn=None):
        """Dispatch both strands on the batched engine, one upload of the
        texts for both, and return ``finish()``. Patterns of any lengths
        share the call: the engine groups them by row bucket and overhang
        steps."""
        prof = self.profile
        pcodes = [prof.encode(p) for p in pats]
        fwd_texts = [t.text() for t in rc_texts]
        ts = TextSet(fwd_texts, self.device)
        fin = self.batch.candidates_many_async(
            prof, pcodes, ts, k, self.alpha, self.max_overhang, all_minima)
        rfin = comp = ccodes = None
        if rc:
            comp = [as_bytes_array(prof.complement(p)) for p in pats]
            ccodes = [prof.encode(c) for c in comp]
            rfin = self.batch.candidates_many_async(
                prof, ccodes, ts, k, self.alpha, self.max_overhang,
                all_minima, reverse=True,
            )
        return lambda: self._finish_many_batched(
            fin, rfin, pats, pcodes, comp, ccodes, rc_texts, fwd_texts,
            k, filter_fn,
        )

    def _finish_many_batched(self, fin, rfin, pats, pcodes, comp, ccodes,
                             rc_texts, fwd_texts, k,
                             filter_fn) -> list[Match]:
        cands = fin()
        rcands = rfin() if rfin is not None else None
        out: list[Match] = []
        for pi in range(len(pats)):
            row = cands[pi]
            rrow = rcands[pi] if rcands is not None else None
            for ti in range(len(rc_texts)):
                # read batches are Q x thousands of mostly-empty cells
                if not row[ti] and (rrow is None or not rrow[ti]):
                    continue
                fwd = fwd_texts[ti]
                out.extend(self._postprocess(
                    pats[pi], pcodes[pi], fwd, k, row[ti], filter_fn,
                    Strand.FWD, pi, ti,
                ))
                if rcands is not None:
                    ms = self._postprocess(
                        comp[pi], ccodes[pi], rc_texts[ti].rev_text(), k,
                        rrow[ti], filter_fn, Strand.RC, pi, ti,
                    )
                    out.extend(self._to_forward(ms, len(fwd)))
        return out

    # ------------------------------------------------------------------
    # single-pattern pipeline

    def _to_forward(self, rc_matches: list[Match], n: int) -> list[Match]:
        """RC-strand matches in reversed-text coordinates -> forward."""
        for m in rc_matches:
            m.strand = Strand.RC
            rs, re = m.text_start, m.text_end
            m.text_start = n - re
            m.text_end = UNKNOWN if self.without_trace_flag else n - rs
        return rc_matches

    def _search_handle_rc(self, pattern, text, k: int, all_minima: bool,
                          filter_fn=None, pattern_idx: int = 0,
                          text_idx: int = 0) -> list[Match]:
        pat = as_bytes_array(pattern)
        rc_text = _as_rc_searchable(text)
        fwd = rc_text.text()
        out = self._search_one_strand(pat, fwd, k, all_minima, filter_fn,
                                      Strand.FWD, pattern_idx, text_idx)
        if self.rc:
            comp = as_bytes_array(self.profile.complement(pat))
            out.extend(self._to_forward(self._search_one_strand(
                comp, rc_text.rev_text(), k, all_minima, filter_fn,
                Strand.RC, pattern_idx, text_idx,
            ), len(fwd)))
        return out

    def _search_one_strand(self, pattern: np.ndarray, text: np.ndarray,
                           k: int, all_minima: bool, filter_fn,
                           strand: Strand, pattern_idx: int,
                           text_idx: int) -> list[Match]:
        p_codes = self.profile.encode(pattern)
        cands = self.engine.candidates(
            self.profile, p_codes, text, k, self.alpha, self.max_overhang,
            all_minima,
        )
        return self._postprocess(pattern, p_codes, text, k, cands, filter_fn,
                                 strand, pattern_idx, text_idx)

    def _postprocess(self, pattern: np.ndarray, p_codes: np.ndarray,
                     text: np.ndarray, k: int, cands, filter_fn,
                     strand: Strand, pattern_idx: int,
                     text_idx: int) -> list[Match]:
        """End-position filter, N-fraction pre-filter, only-best selection,
        traceback, traced N-filter (reference search.rs:884-937 +
        process_matches)."""
        m = len(pattern)
        n = len(text)
        if filter_fn is not None:
            cands = [(end, cost) for end, cost in cands
                     if filter_fn(pattern, text[: min(end, n)], strand)]
        if self.max_n_frac is not None:
            cands = [(end, cost) for end, cost in cands
                     if satisfy_n_endpoint_filter(end, text, m, k,
                                                  self.max_n_frac)]
        if self.only_best_match_flag and cands:
            # smallest cost; ties broken by larger end position
            # (search.rs:1392-1411)
            cands = [min(cands, key=lambda ec: (ec[1], -ec[0]))]

        out: list[Match] = []
        if self.without_trace_flag:
            for end, cost in cands:
                out.append(Match(
                    pattern_idx=pattern_idx, text_idx=text_idx,
                    text_start=UNKNOWN, text_end=min(end, n),
                    pattern_start=UNKNOWN,
                    pattern_end=m - max(0, end - n), cost=cost,
                    strand=Strand.FWD,
                ))
        elif cands:
            traced = trace_candidates_batch(
                self.profile, pattern, p_codes, text,
                [end for end, _ in cands], m + k, self.alpha,
                self.max_overhang,
            )
            for (end, cost), mt in zip(cands, traced):
                assert mt.cost <= cost, f"trace cost {mt.cost} > recorded {cost}"
                assert mt.cost <= k
                mt.pattern_idx = pattern_idx
                mt.text_idx = text_idx
                out.append(mt)
        if self.max_n_frac is not None and not self.without_trace_flag:
            out = [mm for mm in out
                   if traced_satisfy_n_frac(mm, text, self.max_n_frac)]
        return out
