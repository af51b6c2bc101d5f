"""The port's :class:`Searcher`: the public API of ``sassy_tpu.Searcher``
(reference sassy src/search.rs:358-784) on the PyTorch/CUDA engines.

``search``, ``search_all``, ``search_with_fn``, ``search_texts``,
``search_patterns``, ``search_many``, ``search_many_with_fn(_async)``, the
encoded-pattern API and ``search_all_alignments``, with reverse
complement, overhang (``alpha``, ``max_overhang``), ``only_best_match``,
``without_trace`` and ``max_n_frac``. Two engines find the candidates on
``device``: ``TorchEngine`` (one pattern, one text) and ``BatchEngine``
(patterns x texts). The end-position filter, the N-fraction filter,
only-best selection and the CIGAR build run on the host, as in the
reference, from the port's own copies of its host modules: one finish
for both engines, over the arrays of all candidates of a strand at once
(``_finish_strand``, ``traceback.trace_cells_batch``), never a loop over
(pattern, text) cells. The traceback reads its windows from the strand's
planes, which the search packed (the batched call's ``TextSet``, the
single engine's ``PreparedText``): on the card its kernel
(``csrc/trace.cu``), on the CPU its plain version.

Reverse-complement handling follows the reference exactly (search.rs:
787-881): search the *complemented* pattern against the *reversed* text,
then map positions back to forward coordinates (``text_start = len -
rc_end``), keeping the CIGAR in pattern direction.
"""

from __future__ import annotations

from itertools import chain, compress, repeat
from typing import NamedTuple

import numpy as np

from . import collector, spans
from .matchrec import UNKNOWN, Match, Strand
from .nfilter import n_fraction_ok
from .ops.batch import BatchEngine, TextSet
from .ops.myers_torch import TorchEngine, engine_device
from .profiles import Profile, as_bytes_array, get_profile
from .traceback import StrandPlanes, TextSpans, trace_cells_batch

__all__ = ["Searcher", "CachedRev", "EncodedPatterns", "SearchMode"]

_STRANDS = (Strand.FWD, Strand.RC)


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
        device = engine_device(device, "Searcher")
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
        #: the last finished call's record (``spans``): its host finish's
        #: steps' seconds and sizes ("filters", "trace" or "gather",
        #: "fill", "walk"; "build", the sum of "unpack", "cigars" and
        #: "match_objects"; the collector's passes during those,
        #: "gc_passes" and "gc_s"; "candidates", "kept", "windows",
        #: "matches"); of a batched call made while a ``torch.profiler``
        #: ran, also its "call_id", counters and "spans"
        self.last_finish_split: dict = {}

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
            return self._search_encoded_v2_async(encoded, [text], k,
                                                 False)()
        return self._search_many_impl(encoded.patterns, [text], k, False,
                                      rc=encoded.include_rc)

    def search_all_encoded_patterns(self, encoded, text,
                                    k: int) -> list[Match]:
        if encoded.rc_anchor == "start":
            return self._search_encoded_v2_async(encoded, [text], k,
                                                 True)()
        return self._search_many_impl(encoded.patterns, [text], k, True,
                                      rc=encoded.include_rc)

    def _search_encoded_v2_async(self, encoded, texts, k: int,
                                 all_minima: bool = False,
                                 textset=None):
        """v2 RC anchor semantics (reference lib.rs:33-40) over ``texts``
        in one batched call: RC(pattern) is one more forward pattern of the
        same batch, and its matches are relabelled as RC ones. Returns
        ``finish()``; the matches are in ``search_many``'s order over the
        2Q patterns (each text's forward patterns' matches before its RC
        patterns'). ``textset``: as ``_search_many_batched_async``'s."""
        pats = encoded.patterns
        rc_texts = [_as_rc_searchable(t) for t in texts]
        if not encoded.include_rc:
            return self._search_many_batched_async(pats, rc_texts, k,
                                                   all_minima, False,
                                                   textset=textset)
        prof = self.profile
        Q = len(pats)
        rc_pats = [as_bytes_array(prof.reverse_complement(p)) for p in pats]
        fin = self._search_many_batched_async(pats + rc_pats, rc_texts, k,
                                              all_minima, False,
                                              textset=textset)
        m_len = encoded.pattern_len

        def finish() -> list[Match]:
            ms_all = fin()
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
        return finish

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

    def _text_set(self, texts) -> TextSet:
        """The batched engine's text set of ``texts`` (their forward
        bytes), for several calls over the same texts (``textset=``)."""
        return TextSet([_as_rc_searchable(t).text() for t in texts],
                       self.device)

    def _search_many_batched_async(self, pats, rc_texts, k: int,
                                   all_minima: bool, rc: bool,
                                   filter_fn=None, textset=None):
        """Dispatch both strands on the batched engine, one upload of the
        texts for both, and return ``finish()``. Patterns of any lengths
        share the call: the engine groups them by row bucket and overhang
        steps. ``textset``: a ``_text_set`` of the same texts, shared with
        other calls (one upload and one pack a strand for all of them);
        without it the call builds its own. The call's record
        (``spans.record``) gets the submit's spans here, the dispatch
        jobs' on the dispatch thread and the finish's in ``finish()``."""
        prof = self.profile
        rec = spans.record()
        with spans.bound(rec), spans.span("submit"):
            with spans.span("encode"):
                pcodes = [prof.encode(p) for p in pats]
            with spans.span("text_set"):
                ts = (textset if textset is not None
                      else self._text_set(rc_texts))
            spans.count(texts=len(ts.lens), text_bytes=ts.nbytes)
            with spans.span("enqueue"):
                fin = self.batch.candidates_many_flat_async(
                    prof, pcodes, ts, k, self.alpha, self.max_overhang,
                    all_minima)
            strands = [(Strand.FWD, pats, pcodes, fin)]
            if rc:
                with spans.span("encode"):
                    comp = [as_bytes_array(prof.complement(p)) for p in pats]
                    ccodes = [prof.encode(c) for c in comp]
                with spans.span("enqueue"):
                    strands.append((Strand.RC, comp, ccodes,
                                    self.batch.candidates_many_flat_async(
                                        prof, ccodes, ts, k, self.alpha,
                                        self.max_overhang, all_minima,
                                        reverse=True)))
        return lambda: self._finish_many_batched(strands, ts, k, filter_fn,
                                                 rec)

    def _finish_many_batched(self, strands, ts: TextSet, k: int,
                             filter_fn, rec: dict | None = None
                             ) -> list[Match]:
        """Each strand's flat candidate columns, waited for in turn (the
        forward strand's finish overlaps the reverse strand's device
        work), finished as arrays, then one Match list in the reference's
        order. ``strands``: (strand, its patterns, their codes, the
        engine's ``finish()``); ``ts``: the call's text set, whose planes
        the traceback reads; ``rec``: the call's record (None: a new one),
        published as ``last_finish_split`` at the end."""
        if rec is None:
            rec = spans.record()
        texts = ts.texts
        lens = np.fromiter(map(len, texts), np.int64, len(texts))
        with spans.bound(rec), spans.span("finish"):
            found = [self._finish_strand(
                pats, codes, texts, lens, fin(), k, filter_fn, strand,
                lambda rc=strand is Strand.RC: StrandPlanes(
                    *ts.strand_planes(self.profile, rc)))
                for strand, pats, codes, fin in strands]
            out = self._matches(found, lens)
        self.last_finish_split = rec
        return out

    # ------------------------------------------------------------------
    # single-pattern pipeline

    def _search_handle_rc(self, pattern, text, k: int, all_minima: bool,
                          filter_fn=None, pattern_idx: int = 0,
                          text_idx: int = 0) -> list[Match]:
        """One pattern on one text, both strands with ``rc``: their planes
        come from one upload of the forward bytes
        (``TorchEngine.prepare_strands``, kept while a read-only source
        lives); the traceback reads each strand's own planes, and the
        host finish's filters the forward bytes backwards for the reverse
        strand."""
        pat = as_bytes_array(pattern)
        fwd = _as_rc_searchable(text).text()
        lens = np.array([len(fwd)], np.int64)
        split: dict = {}
        with spans.bound(split):
            if not self.rc:
                found = [self._search_one_strand(
                    pat, fwd, self.engine.prepare(self.profile, fwd), k,
                    all_minima, filter_fn, Strand.FWD)]
            else:
                comp = as_bytes_array(self.profile.complement(pat))
                fprep, rprep = self.engine.prepare_strands(self.profile, fwd)
                found = [
                    self._search_one_strand(pat, fwd, fprep, k, all_minima,
                                            filter_fn, Strand.FWD),
                    self._search_one_strand(comp, fwd, rprep, k, all_minima,
                                            filter_fn, Strand.RC),
                ]
            out = self._matches(found, lens, pattern_idx, text_idx)
        self.last_finish_split = split
        return out

    def _search_one_strand(self, pattern: np.ndarray, text: np.ndarray,
                           prepared, k: int, all_minima: bool, filter_fn,
                           strand: Strand) -> "_Found":
        """The candidates of one strand on ``prepared`` (its
        ``PreparedText``), finished as one cell: the traceback on its
        planes, the filters on the host ``text`` (the forward bytes: read
        backwards for RC)."""
        p_codes = self.profile.encode(pattern)
        cands = self.engine.candidates(
            self.profile, p_codes, prepared, k, self.alpha,
            self.max_overhang, all_minima,
        )
        pos_cost = np.array(cands, np.int64).reshape(-1, 2).T
        zeros = np.zeros(pos_cost.shape[1], np.int64)
        return self._finish_strand(
            [pattern], [p_codes], [text], np.array([len(text)], np.int64),
            (zeros, zeros, *pos_cost), k, filter_fn, strand,
            lambda: StrandPlanes(prepared.planes, np.zeros(1, np.int64)))

    # ------------------------------------------------------------------
    # the host finish, shared by both engines

    def _finish_strand(self, pats, pcodes, texts, lens: np.ndarray, cols,
                       k: int, filter_fn, strand: Strand,
                       planes) -> "_Found":
        """End-position filter, N-fraction pre-filter, only-best selection,
        traceback, traced N-filter (reference search.rs:884-937 +
        process_matches) over all candidates of one strand at once.

        ``cols``: (pattern, text, end, cost) columns, sorted by them, as
        the batched engine's flat candidates are; positions are in the
        strand's text, which for RC is the forward text read backwards.
        ``planes()``: the strand's ``StrandPlanes``, which the traceback
        reads (called only where a candidate is traced). Returns the kept
        matches, in the strand's coordinates. The steps' seconds and sizes
        go into the record this thread has bound (``spans.bound``)."""
        split = spans.current()
        with spans.step(split, "filters"):
            q, t, end, cost = (np.asarray(c, np.int64) for c in cols)
            reverse = strand is Strand.RC
            n_cands = len(q)
            plen = np.fromiter(map(len, pats), np.int64, len(pats))
            if filter_fn is not None and len(q):
                keep = self._end_filter(filter_fn, pats, texts, lens, q, t,
                                        end, strand)
                q, t, end, cost = q[keep], t[keep], end[keep], cost[keep]
            e = np.minimum(end, lens[t])
            m = plen[q]
            if self.max_n_frac is not None and len(q):
                # the mandatory window text[e - (m - k) : e], over m + k
                ln = np.minimum(e, np.maximum(0, m - k))
                count = TextSpans(texts, lens, t, e - ln, ln,
                                  reverse).n_counts(e - ln, e)
                keep = n_fraction_ok(count, ln, self.max_n_frac, m + k)
                q, t, end, cost, e, m = (a[keep]
                                         for a in (q, t, end, cost, e, m))
            seq = np.arange(len(q))
            if self.only_best_match_flag and len(q):
                # smallest cost; ties broken by larger end position
                # (search.rs:1392-1411), one a (pattern, text) cell
                order = np.lexsort((-end, cost, t, q))
                cell = q[order] * len(texts) + t[order]
                seq = order[np.r_[True, cell[1:] != cell[:-1]]]
        spans.add(split, candidates=n_cands, kept=len(seq))

        if self.without_trace_flag:
            q, t, end, cost, e, m = (a[seq] for a in (q, t, end, cost, e, m))
            return _Found(strand, q, t, seq, cost, None, e, None,
                          m - np.maximum(0, end - lens[t]), None)
        parts = []
        strand_planes = planes() if len(seq) else None
        for mv in np.unique(m[seq]).tolist():
            rows = seq[m[seq] == mv]
            tr = trace_cells_batch(
                self.profile, pats, pcodes, texts, lens, q[rows], t[rows],
                end[rows], mv + k, self.alpha, self.max_overhang,
                strand_planes, reverse, split)
            assert (tr.cost <= cost[rows]).all(), "trace cost > recorded cost"
            assert (tr.cost <= k).all()
            with spans.step(split, "filters"):
                if self.max_n_frac is not None:
                    span = tr.text_end - tr.text_start
                    keep = n_fraction_ok(
                        TextSpans(texts, lens, t[rows], tr.text_start, span,
                                  reverse).n_counts(tr.text_start,
                                                    tr.text_end),
                        span, self.max_n_frac)
                else:
                    keep = np.ones(len(rows), bool)
            parts.append((rows[keep], tr, keep))
        rows = np.concatenate([p[0] for p in parts] or [seq[:0]])

        def cat(f):
            return np.concatenate([getattr(tr, f)[kp] for _, tr, kp in parts]
                                  or [seq[:0]])

        cigars = [c for _, tr, kp in parts
                  for c in compress(tr.cigars, kp.tolist())]
        return _Found(strand, q[rows], t[rows], rows, cat("cost"),
                      cat("text_start"), cat("text_end"),
                      cat("pattern_start"), cat("pattern_end"), cigars)

    def _end_filter(self, filter_fn, pats, texts, lens, q, t, end,
                    strand: Strand) -> np.ndarray:
        """``filter_fn`` over a strand's candidates: a mask. A filter with
        ``mask_ends(text, ends, strand)`` gets one call a text (all of that
        text's ends); a plain callable keeps its contract, one call a
        candidate with ``(pattern, text[:min(end, n)], strand)``. Texts are
        the strand's: the forward bytes read backwards for RC."""
        step = -1 if strand is Strand.RC else 1
        keep = np.zeros(len(q), bool)
        mask_ends = getattr(filter_fn, "mask_ends", None)
        if mask_ends is not None:
            order = np.argsort(t, kind="stable")
            ts = t[order]
            cuts = np.flatnonzero(ts[1:] != ts[:-1]) + 1
            for rows in np.split(order, cuts):
                keep[rows] = mask_ends(texts[t[rows[0]]][::step], end[rows],
                                       strand)
            return keep
        e = np.minimum(end, lens[t])
        for b, (qi, ti, eb) in enumerate(zip(q.tolist(), t.tolist(),
                                             e.tolist())):
            keep[b] = filter_fn(pats[qi], texts[ti][::step][:eb], strand)
        return keep

    def _matches(self, found: list["_Found"], lens: np.ndarray,
                 pattern_idx: int = 0, text_idx: int = 0) -> list[Match]:
        """The strands' matches as one list in the reference's order:
        pattern, then text; in a (pattern, text) cell the forward strand's
        matches in candidate order, then the reverse strand's, in forward
        coordinates (``text_start = n - rc_end``). Indices are offset by
        ``pattern_idx`` and ``text_idx``."""
        split = spans.current()
        with collector.paused(split), spans.span("build"), \
                spans.step(split, "match_objects", build=True):
            q, t, seq, cost, te, pe = (
                np.concatenate([getattr(f, a) for f in found])
                for a in ("q", "t", "seq", "cost", "text_end",
                          "pattern_end"))
            strand = np.concatenate([np.full(len(f.q), int(f.strand))
                                     for f in found])
            rc = strand == int(Strand.RC)
            n = lens[t]
            order = np.lexsort((seq, strand, t, q))
            qs, tis, costs, pes = (a[order].tolist() for a in (
                q + pattern_idx, t + text_idx, cost, pe))
            strands = list(map(_STRANDS.__getitem__,
                               strand[order].tolist()))
            if self.without_trace_flag:
                ends = np.where(rc, n - te, te)[order].tolist()
                out = list(map(
                    Match, qs, tis,
                    [e if sd else UNKNOWN for e, sd in zip(ends, strands)],
                    [UNKNOWN if sd else e for e, sd in zip(ends, strands)],
                    repeat(UNKNOWN), pes, costs, strands))
            else:
                ts, ps = (np.concatenate([getattr(f, a) for f in found])
                          for a in ("text_start", "pattern_start"))
                ts, te = np.where(rc, n - te, ts), np.where(rc, n - ts, te)
                cigars = list(chain.from_iterable(f.cigars for f in found))
                out = list(map(Match, qs, tis, ts[order].tolist(),
                               te[order].tolist(), ps[order].tolist(), pes,
                               costs, strands,
                               map(cigars.__getitem__, order.tolist())))
        spans.add(split, matches=len(out))
        return out


class _Found(NamedTuple):
    """One strand's finished matches: pattern and text indices, each
    match's candidate's rank among the strand's candidates (``seq``, which
    orders them), cost, coordinates in the strand's text (``text_start``,
    ``pattern_start`` and ``cigars`` None without trace)."""

    strand: Strand
    q: np.ndarray
    t: np.ndarray
    seq: np.ndarray
    cost: np.ndarray
    text_start: np.ndarray | None
    text_end: np.ndarray
    pattern_start: np.ndarray | None
    pattern_end: np.ndarray
    cigars: list | None
