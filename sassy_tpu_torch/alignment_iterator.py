"""Enumerate *all* (sufficiently distinct) alignments with cost <= k.

Host-side port of the reference's bounded DFS
(sassy src/alignment_iterator.rs): for every end position found by
a trace-less ``search_all``, walk backwards through the DP matrix exploring
Match/Sub/Del/Ins edges bounded by ``cost_so_far + prefix_cost <= k``, with
the reference's pruning rules:

- no leading or trailing deletions (alignment_iterator.rs:259-262);
- may not *leave* a diagonal that exact matches extend to the top
  (:293-300);
- may not *enter* a diagonal reachable by exact matches from the bottom or
  from the last visit (:305-320, ``last_row_in_diagonal``);
- never both insertions and deletions since the last match (:324-327);
- edges explored in order of total cost, Match/Sub first on ties (:333).

This is enumeration, not throughput — it stays on the host by design (the
candidate end positions come from the device engines).

The port's own copy of ``sassy_tpu/alignment_iterator.py`` (the port imports nothing
of the JAX package); tests/test_torch_copies.py holds the two equal.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from .cigar import DEL, INS, MATCH, SUB, Cigar
from .matchrec import Match, Strand
from .nfilter import traced_satisfy_n_frac
from .oracle import dp_matrix
from .profiles import as_bytes_array

CONTINUE = "continue"
PRUNE = "prune"
BREAK = "break"

# (text_delta, pattern_delta, edit_cost)
_DELTAS = {MATCH: (1, 1, 0), SUB: (1, 1, 1), DEL: (1, 0, 1), INS: (0, 1, 1)}


def net_insertions_since_last_match(cigar: Cigar) -> int:
    net = 0
    for op, cnt in reversed(cigar.ops):
        if op == MATCH:
            break
        if op == INS:
            net += cnt
        elif op == DEL:
            net -= cnt
    return net


@dataclass
class _Ctx:
    profile: object
    pattern: np.ndarray
    text: np.ndarray
    range_start: int
    D: np.ndarray  # (m+1, len(range)+1) cost matrix
    m: Match
    k: int
    partial_matches: bool
    callback: object
    last_row_in_diagonal: list = field(default_factory=list)

    def dfs(self) -> str:
        mm = self.m
        full_match = mm.pattern_start == 0
        if full_match or self.partial_matches:
            mm.cigar.reverse()
            cont = self.callback(full_match, mm)
            mm.cigar.reverse()
            if cont == PRUNE:
                return CONTINUE
            if cont == BREAK:
                return BREAK

        m_len = len(self.pattern)
        t_pos, p_pos = mm.text_start, mm.pattern_start

        edges = []
        for op in (MATCH, DEL, INS):
            dt, dp, _ = _DELTAS[op]
            # no leading or trailing deletions
            if op == DEL and (p_pos == 0 or p_pos == m_len):
                continue
            if t_pos < dt or p_pos < dp:
                continue
            nt, npp = t_pos - dt, p_pos - dp
            if nt < self.range_start:
                continue
            eop = op
            if op == MATCH and not self.profile.is_match(
                int(self.pattern[npp]), int(self.text[nt])
            ):
                eop = SUB
            cost = self._DELTA_COST[eop]
            total = mm.cost + cost + int(self.D[npp, nt - self.range_start])
            if total > self.k:
                continue

            if op in (DEL, INS):
                # may not leave a diagonal extendable by exact matches to top
                pat_slice = self.pattern[:p_pos]
                ts = max(t_pos - p_pos, 0)
                text_slice = self.text[ts:t_pos]
                if self.profile.is_match_slice(pat_slice, text_slice):
                    continue
                # may not enter a diagonal reachable by exact matches from
                # the bottom / last visit
                diag = nt + m_len - self.range_start - npp
                last = self.last_row_in_diagonal[diag]
                pat_slice = self.pattern[npp:last]
                text_end = nt + len(pat_slice)
                if text_end <= len(self.text):
                    text_slice = self.text[nt:text_end]
                    if self.profile.is_match_slice(pat_slice, text_slice):
                        continue
                # no mixed ins+del since last match
                net_ins = net_insertions_since_last_match(mm.cigar)
                if (op == INS and net_ins < 0) or (op == DEL and net_ins > 0):
                    continue

            edges.append((eop, total))

        edges.sort(key=lambda e: e[1])  # stable: Match/Sub first on ties

        for eop, _total in edges:
            dt, dp, c = _DELTAS[eop]
            nt, npp = t_pos - dt, p_pos - dp
            diag = nt + m_len - self.range_start - npp
            old_last = self.last_row_in_diagonal[diag]
            self.last_row_in_diagonal[diag] = npp

            mm.text_start = nt
            mm.pattern_start = npp
            mm.cost += c
            mm.cigar.push(eop)
            cont = self.dfs()
            mm.text_start = t_pos
            mm.pattern_start = p_pos
            mm.cost -= c
            # pop one unit of eop
            op0, cnt0 = mm.cigar.ops[-1]
            assert op0 == eop
            if cnt0 == 1:
                mm.cigar.ops.pop()
            else:
                mm.cigar.ops[-1] = (op0, cnt0 - 1)

            self.last_row_in_diagonal[diag] = old_last
            if cont == BREAK:
                return BREAK
        return CONTINUE

    _DELTA_COST = {MATCH: 0, SUB: 1, DEL: 1, INS: 1}


def iterate_all_alignments(
    searcher, pattern, text, k: int, matches: list[Match], partial_matches: bool, callback
) -> None:
    """See reference alignment_iterator.rs:52-119. ``matches`` must be the
    output of a trace-less ``search_all`` (Fwd entries first, then Rc)."""
    if searcher.alpha is not None:
        raise AssertionError(
            "Tracing all alignments with overhang is not yet implemented."
        )
    from .search import _as_rc_searchable

    rc_text = _as_rc_searchable(text)
    pat = as_bytes_array(pattern)
    fwd_text = rc_text.text()
    split = 0
    while split < len(matches) and matches[split].strand is Strand.FWD:
        split += 1
    fwd, rc = matches[:split], matches[split:]

    if fwd:
        _iterate_one_strand(
            searcher, pat, fwd_text, k, fwd, partial_matches, callback, None
        )
    if rc:
        fwd_len = len(fwd_text)
        rev_text = rc_text.rev_text()
        comp = as_bytes_array(searcher.profile.complement(pat))

        def rc_callback(complete: bool, m: Match) -> str:
            os_, oe, ost = m.text_start, m.text_end, m.strand
            m.text_start = fwd_len - oe
            m.text_end = fwd_len - os_
            m.strand = Strand.RC
            result = callback(complete, m)
            m.text_start, m.text_end, m.strand = os_, oe, ost
            return result

        _iterate_one_strand(
            searcher, comp, rev_text, k, rc, partial_matches, rc_callback, fwd_len
        )


def _iterate_one_strand(
    searcher, pattern, text, k, matches, partial_matches, callback, flip
) -> None:
    profile = searcher.profile
    m_len = len(pattern)
    width = k + m_len

    def eff_end(m: Match) -> int:
        return m.text_end if flip is None else flip - m.text_start

    # group nearby end positions so one DP fill serves each group
    ranges: list[tuple[int, int]] = []
    if matches:
        first_end = max(0, eff_end(matches[0]) - width)
        last_end = eff_end(matches[0])
        for m in matches[1:]:
            e = eff_end(m)
            if e <= last_end + width:
                last_end = e
            else:
                ranges.append((first_end, last_end))
                first_end = max(0, e - width)
                last_end = e
        ranges.append((first_end, last_end))

    p_codes = profile.encode(pattern)
    t_codes = profile.encode(text)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * (m_len + k) + 1000))
    try:
        for start, end in ranges:
            D = dp_matrix(profile, p_codes, t_codes[start:end], None, None)
            last_row = [m_len] * (end - start + m_len + 1)
            for text_end in range(start, end + 1):
                if D[m_len, text_end - start] > k:
                    continue
                mm = Match(
                    pattern_start=m_len,
                    pattern_end=m_len,
                    text_start=text_end,
                    text_end=text_end,
                    cost=0,
                    strand=Strand.FWD,
                    cigar=Cigar(),
                )
                ctx = _Ctx(
                    profile=profile,
                    pattern=pattern,
                    text=text,
                    range_start=start,
                    D=D,
                    m=mm,
                    k=k,
                    partial_matches=partial_matches,
                    callback=callback,
                    last_row_in_diagonal=last_row,
                )
                ctx.dfs()
    finally:
        sys.setrecursionlimit(old_limit)


def search_all_alignments(searcher, pattern, text, k: int) -> list[list[Match]]:
    """All distinct alignments per end position, grouped by (strand, anchor)
    (reference search.rs:708-754)."""
    from .search import _as_rc_searchable

    rc_text = _as_rc_searchable(text)
    had_trace = searcher.without_trace_flag
    searcher.without_trace_flag = True
    try:
        all_matches = searcher.search_all(pattern, rc_text, k)
    finally:
        searcher.without_trace_flag = had_trace

    flat: list[Match] = []

    def cb(complete: bool, m: Match) -> str:
        if complete:
            flat.append(
                Match(
                    pattern_idx=m.pattern_idx,
                    text_idx=m.text_idx,
                    text_start=m.text_start,
                    text_end=m.text_end,
                    pattern_start=m.pattern_start,
                    pattern_end=m.pattern_end,
                    cost=m.cost,
                    strand=m.strand,
                    cigar=Cigar(ops=list(m.cigar.ops)),
                )
            )
        return CONTINUE

    iterate_all_alignments(searcher, pattern, rc_text, k, all_matches, False, cb)

    if searcher.max_n_frac is not None:
        fwd = rc_text.text()
        flat = [m for m in flat if traced_satisfy_n_frac(m, fwd, searcher.max_n_frac)]

    def anchor(m: Match):
        return (int(m.strand), m.text_end if m.strand is Strand.FWD else m.text_start)

    groups: list[list[Match]] = []
    for m in flat:
        if groups and anchor(groups[-1][0]) == anchor(m):
            groups[-1].append(m)
        else:
            groups.append([m])
    return groups
