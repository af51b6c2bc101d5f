"""What decides ``correct``: the program's Match lists held to the reference.

During the window a ``Sampler`` keeps the Match lists of a reservoir of
calls drawn from the seed, and each pool call's first match count. After
the window, for each kept call:

- every match the program returned is checked: the reference searches its
  pattern on its strand around its end (``reference.search.Area``), and the
  program's matches there must be exactly the reference's, start, cost and
  CIGAR included;
- areas drawn from the seed (whole texts, planted copies, random stretches,
  the ends of texts) are checked for every pattern on both strands, so a
  match the program left out shows;
- the list must be in the order the search promises: pattern, text, strand
  (forward first), then the end on that strand.

Besides, every call must return, and every call over the same texts must
return as many matches as the first one did. Each number has its limit;
``correct`` holds when none is over it.
"""

from __future__ import annotations

import random
import time

import numpy as np

from .reference.search import Area, search_areas

__all__ = ["Sampler", "program_rows", "run_checks", "passed",
           "order_faults", "LIMITS"]

#: the limit of each number compared: all exact, 0 (the least number of
#: matches a run has to have compared is the cell's ``min_compared``)
LIMITS = {"mismatched_matches": 0, "order_faults": 0, "failed_calls": 0,
          "unequal_repeat_counts": 0}


class Sampler:
    """``on_done`` of the window's loop: a reservoir of ``keep`` calls,
    drawn from ``seed``, each kept as the rows of its Match list
    (``program_rows(matches, lens_of(call))``: plain tuples, which the
    collector stops tracking, so that the kept lists do not slow the
    program's collector passes), and the number of calls whose match count
    differs from the first call's over the same texts."""

    def __init__(self, keep: int, seed: int, lens_of):
        self.keep = keep
        self.rng = random.Random(seed)
        self.lens_of = lens_of
        self.kept: list = []
        self.first_count: dict = {}
        self.unequal = 0
        self.seen = 0

    def __call__(self, call, matches) -> None:
        if matches is None:
            return
        first = self.first_count.setdefault(call.batch, len(matches))
        self.unequal += first != len(matches)
        slot = len(self.kept) if len(self.kept) < self.keep else \
            self.rng.randrange(self.seen + 1)
        if slot < self.keep:
            entry = (call, *program_rows(matches, self.lens_of(call)))
            if slot == len(self.kept):
                self.kept.append(entry)
            else:
                self.kept[slot] = entry
        self.seen += 1


def program_rows(matches, lens: np.ndarray):
    """The program's matches as tuples (pattern, text, strand, start, end,
    pattern start, pattern end, cost, CIGAR), and the count of those whose
    text or coordinates are out of range."""
    rows, bad = [], 0
    for m in matches:
        t, s = int(m.text_idx), int(m.strand)
        try:
            start, end = int(m.text_start), int(m.text_end)
            ok = (0 <= t < len(lens) and s in (0, 1)
                  and 0 <= start <= end <= lens[t])
        except (TypeError, ValueError):
            ok = False
        if not ok:
            bad += 1
            continue
        rows.append((int(m.pattern_idx), t, s, start, end,
                     int(m.pattern_start), int(m.pattern_end), int(m.cost),
                     "" if m.cigar is None else str(m.cigar)))
    return rows, bad


def _strand_end(rows, lens: np.ndarray) -> np.ndarray:
    """Each row's end on its own strand: the forward end, or n - start."""
    a = np.array([(r[1], r[2], r[3], r[4]) for r in rows],
                 np.int64).reshape(-1, 4)
    return np.where(a[:, 1] == 0, a[:, 3], lens[a[:, 0]] - a[:, 2])


def order_faults(rows, lens: np.ndarray) -> int:
    """Neighbours in the list that are not in strictly rising order of
    (pattern, text, strand, end on the strand)."""
    if len(rows) < 2:
        return 0
    key = np.array([(r[0], r[1], r[2]) for r in rows], np.int64)
    key = np.concatenate([key, _strand_end(rows, lens)[:, None]], axis=1)
    d = key[1:] - key[:-1]
    nz = d != 0
    first = np.argmax(nz, axis=1)
    rising = nz.any(axis=1) & (d[np.arange(len(d)), first] > 0)
    return int((~rising).sum())


def _areas(check: dict, inputs, texts_idx: np.ndarray, lens: np.ndarray,
           rows, rng) -> list:
    """The areas of one kept call: around each match the program returned,
    and the drawn areas for every pattern."""
    areas = [Area(r[1], r[4], r[4], (r[0],), (0,)) if r[2] == 0
             else Area(r[1], r[3], r[3], (r[0],), (1,)) for r in rows]
    n = len(lens)
    small = np.flatnonzero(lens <= check["whole_text_max_bp"])
    for t in rng.choice(small, min(len(small), check["whole_texts"]),
                        replace=False).tolist():
        areas.append(Area(t, 0, int(lens[t])))
    local = {int(g): i for i, g in enumerate(texts_idx.tolist())}
    plants = [p for p in inputs.plants.tolist() if p[0] in local]
    for i in rng.permutation(len(plants))[:check["plant_areas"]].tolist():
        g, start, end = plants[i][:3]
        t = local[g]
        areas.append(Area(t, max(0, start - check["plant_margin"]),
                          min(int(lens[t]), end + check["plant_margin"])))
    bp = check["area_bp"]
    for _ in range(check["random_areas"]):
        t = int(rng.choice(n, p=lens / lens.sum()))
        x = int(rng.integers(max(1, lens[t] - bp)))
        areas.append(Area(t, x, min(int(lens[t]), x + bp)))
    long_ = np.flatnonzero(lens > bp)
    for t in rng.choice(long_, min(len(long_), check["text_end_areas"]),
                        replace=False).tolist():
        areas.extend([Area(t, 0, bp), Area(t, int(lens[t]) - bp,
                                           int(lens[t]))])
    return areas


def _selected(rows, lens: np.ndarray, checked: np.ndarray, Q: int) -> set:
    """The program's rows whose (text, strand, pattern) and end on the
    strand fall in one of the ``checked`` ranges."""
    if not rows or not len(checked):
        return set()
    big = 1 << 40
    a = np.array([(r[1], r[2], r[0]) for r in rows], np.int64)
    key = ((a[:, 0] * 2 + a[:, 1]) * Q + a[:, 2]) * big + _strand_end(rows,
                                                                       lens)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    ck = (checked[:, 0] * 2 + checked[:, 1]) * Q + checked[:, 2]
    lo = np.searchsorted(ks, ck * big + checked[:, 3], side="left")
    hi = np.searchsorted(ks, ck * big + checked[:, 4], side="right")
    cover = np.zeros(len(ks) + 1, np.int64)
    np.add.at(cover, lo, 1)
    np.add.at(cover, hi, -1)
    inside = order[np.cumsum(cover)[:-1] > 0]
    return {rows[i] for i in inside.tolist()}


def run_checks(inputs, config: dict, check: dict, sampler: Sampler, calls,
               seed: int, device, log=print) -> dict:
    """Every number compared, each with its value and limit (see the
    module's doc)."""
    t0 = time.perf_counter()
    k = config["k"]
    Q = len(inputs.patterns)
    mismatched = order = compared = 0
    for call, rows, bad in sorted(sampler.kept, key=lambda x: x[0].index):
        texts_idx = inputs.calls[call.batch]
        texts = [inputs.text(i) for i in texts_idx.tolist()]
        lens = inputs.lengths[texts_idx]
        order += order_faults(rows, lens)
        rng = np.random.default_rng([int(seed) % (1 << 64), call.index])
        areas = _areas(check, inputs, texts_idx, lens, rows, rng)
        found, checked = search_areas(inputs.patterns, texts, k, areas,
                                      device)
        got = _selected(rows, lens, checked, Q)
        miss, extra = found - got, got - found
        # a returned match that no checked range holds (the scan's state
        # before it was never found) is counted against the program too
        extra |= set(rows) - got
        mismatched += bad + len(miss) + len(extra)
        compared += len(found & got)
        for what, few in (("the reference found, the program did not",
                           miss), ("the program returned, the reference "
                                   "did not find or check", extra)):
            for r in sorted(few)[:3]:
                log(f"call {call.index}: {what}: {r}")
        log(f"call {call.index} (pool call {call.batch}): {len(rows)} "
            f"matches, {len(areas)} areas, {len(checked)} ranges checked, "
            f"{len(found)} found by the reference, {bad} out of range")
    failed = sum(c.error is not None for c in calls)
    log(f"reference check: {len(sampler.kept)} calls in "
        f"{time.perf_counter() - t0:.1f} s")
    values = {"mismatched_matches": mismatched, "order_faults": order,
              "failed_calls": failed,
              "unequal_repeat_counts": sampler.unequal}
    out = {name: {"value": v, "limit": LIMITS[name]}
           for name, v in values.items()}
    out["compared_matches"] = {"value": compared,
                               "limit": check["min_compared"],
                               "at_least": True}
    return out


def passed(checks: dict) -> bool:
    """Whether every number is within its limit."""
    return all(c["value"] >= c["limit"] if c.get("at_least")
               else c["value"] <= c["limit"] for c in checks.values())
