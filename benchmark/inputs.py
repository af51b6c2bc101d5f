"""The one generator of the benchmark's inputs, driven by a configuration
file and a traffic file.

A configuration gives the patterns (random ACGT of a length, with a fixed
suffix such as a PAM), the texts (reads whose lengths follow a law, or
records of stated lengths) and how copies of the patterns are planted in
them (at the ends of reads, or one every so many bases). The traffic gives
how many texts a call takes and how many calls the pool holds. The bases
are drawn on the device from the seed in a few large calls and copied to
one read-only host buffer; the patterns and the plants are drawn on the
host from the same seed. The lengths come from the configuration's own
seed, so every run seed has the same calls, of the same sizes, in another
order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Inputs", "make_inputs", "read_lengths", "seed_streams"]

BASES = np.frombuffer(b"ACGT", np.uint8)
#: bases drawn on the device in one call
DRAW_CHUNK = 1 << 28


@dataclass
class Inputs:
    """Patterns, texts and plants of one run.

    ``buf``: every text's bytes, back to back, read-only; text i is
    ``buf[offsets[i]:offsets[i] + lengths[i]]``. ``calls``: the texts of
    each call of the pool, as index arrays. ``plants``: one row a planted
    copy: text, start, end (forward coordinates), pattern, orientation (0
    forward, 1 reverse complement), edits."""

    patterns: list
    buf: np.ndarray
    offsets: np.ndarray
    lengths: np.ndarray
    calls: list
    plants: np.ndarray

    def text(self, i: int) -> np.ndarray:
        o = int(self.offsets[i])
        return self.buf[o:o + int(self.lengths[i])]

    def call_texts(self, c: int) -> list:
        """New read-only array objects over the texts of pool call c."""
        return [self.text(i) for i in self.calls[c].tolist()]


def seed_streams(seed: int):
    """(numpy generator, torch seed) of a run seed: any whole number."""
    ss = np.random.SeedSequence(int(seed) % (1 << 128))
    torch_seed = int(ss.generate_state(2, np.uint64)[0]) >> 1
    return np.random.default_rng(ss), torch_seed


def read_lengths(law: dict, count: int) -> np.ndarray:
    """``count`` read lengths from the configuration's law: log-normal with
    the stated mean and sigma (of the log), clipped, drawn from the law's
    own seed."""
    rng = np.random.default_rng(law["seed"])
    mu = np.log(law["mean"]) - law["sigma"] ** 2 / 2
    x = rng.lognormal(mu, law["sigma"], count)
    return np.clip(np.rint(x), law["min"], law["max"]).astype(np.int64)


def _random_bases(total: int, torch_seed: int, device) -> np.ndarray:
    """``total`` random ACGT bytes, drawn on ``device``, on the host."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(torch_seed)
    table = torch.from_numpy(BASES.copy()).to(dev)
    out = np.empty(total, np.uint8)
    host = torch.from_numpy(out)
    for c0 in range(0, total, DRAW_CHUNK):
        c1 = min(total, c0 + DRAW_CHUNK)
        idx = torch.randint(0, 4, (c1 - c0,), generator=gen, device=dev,
                            dtype=torch.uint8)
        host[c0:c1].copy_(table[idx.long()])
    return out


def _patterns(spec: dict, rng) -> list:
    suffix = np.frombuffer(spec.get("suffix", "").encode(), np.uint8)
    body = spec["length"] - len(suffix)
    return [np.concatenate([rng.choice(BASES, body), suffix])
            for _ in range(spec["count"])]


_RC = np.zeros(256, np.uint8)
_RC[list(b"ACGT")] = list(b"TGCA")
_INDEX = np.zeros(256, np.int64)
_INDEX[list(b"ACGT")] = range(4)


def _copy(pattern, edits: int, span: int, kinds, where, draws, fills):
    """A planted copy of ``pattern``: each 'N' the base ``fills`` draws,
    then ``edits`` edits among the first ``span`` characters, the e-th a
    substitution (``kinds[e]`` 0), an insertion (1) or a deletion (2) at
    the share ``where[e]`` of that span, with the base ``draws[e]``
    picks."""
    seq = [int(BASES[f]) if c == ord("N") else int(c)
           for c, f in zip(pattern.tolist(), fills)]
    for e in range(edits):
        at = int(where[e] * min(span, len(seq)))
        if kinds[e] == 0:
            seq[at] = int(BASES[(_INDEX[seq[at]] + 1 + draws[e] % 3) % 4])
        elif kinds[e] == 1:
            seq.insert(at, int(BASES[draws[e]]))
            span += 1
        else:
            del seq[at]
            span -= 1
    return np.array(seq, np.uint8)


def make_inputs(config: dict, traffic: dict, seed: int, device) -> Inputs:
    """The run's inputs (see the module's doc)."""
    rng, torch_seed = seed_streams(seed)
    texts = config["texts"]
    per_call = traffic.get("texts_per_call")
    pool = traffic.get("pool_calls", 1)
    if texts["kind"] == "reads":
        # every seed has the same calls' sizes, in another order: the law
        # fixes each call's reads, the seed orders the calls and the reads
        lengths = read_lengths(texts["length"], per_call * pool)
        lengths = lengths.reshape(pool, per_call)[rng.permutation(pool)]
        lengths = np.concatenate([row[rng.permutation(per_call)]
                                  for row in lengths])
    elif texts["kind"] == "records":
        lengths = np.array(texts["lengths"], np.int64)
    else:
        raise ValueError(f"unknown kind of texts {texts['kind']!r}")
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    buf = _random_bases(int(lengths.sum()), torch_seed, device)
    patterns = _patterns(config["patterns"], rng)
    plants = _plant(config["plant"], patterns, buf, offsets, lengths, rng)
    buf.flags.writeable = False
    n = len(lengths)
    size = per_call or n
    calls = [np.arange(c * size, min(n, (c + 1) * size)) for c in range(pool)]
    return Inputs(patterns, buf, offsets, lengths, calls, plants)


def _plant(spec: dict, patterns, buf, offsets, lengths, rng) -> np.ndarray:
    """Write the planted copies into ``buf``; returns their rows."""
    lo, hi = spec["edits"]
    sites = _sites(spec, patterns, lengths, rng, hi)
    k = len(sites)
    longest = max(len(p) for p in patterns)
    edits = rng.integers(lo, hi + 1, k)
    kinds = rng.integers(3, size=(k, hi))
    where = rng.random((k, hi))
    draws = rng.integers(4, size=(k, hi))
    fills = rng.integers(4, size=(k, longest))
    rows = []
    for r, (t, at, q, orient) in enumerate(sites.tolist()):
        span = spec.get("edit_span", len(patterns[q]))
        seq = _copy(patterns[q], int(edits[r]), span, kinds[r], where[r],
                    draws[r], fills[r])
        if orient:
            seq = _RC[seq[::-1]]
        o = int(offsets[t]) + at
        buf[o:o + len(seq)] = seq
        rows.append((t, at, at + len(seq), q, orient, int(edits[r])))
    return np.array(rows, np.int64).reshape(-1, 6)


def _sites(spec: dict, patterns, lengths, rng, hi: int) -> np.ndarray:
    """Where the copies go: rows (text, start, pattern, orientation)."""
    m = max(len(p) for p in patterns) + hi
    if spec["kind"] == "read_ends":
        # a share of the reads is tagged with one pattern near its start;
        # a share of those also with its reverse complement near the end
        n = len(lengths)
        tagged = np.sort(rng.permutation(n)[:round(spec["tagged_share"] * n)])
        q = rng.integers(len(patterns), size=len(tagged))
        L = lengths[tagged]
        front = rng.integers(np.maximum(1, np.minimum(spec["front_within"], L)
                                        - m))
        rear_w = spec["rear_within"]
        rear = np.zeros(len(tagged), bool)
        rear[rng.permutation(len(tagged))[
            :round(spec["rear_share"] * len(tagged))]] = True
        rear &= L >= spec["front_within"] + rear_w
        at = L - rear_w + rng.integers(rear_w - m, size=len(tagged))
        rows = np.concatenate([
            np.stack([tagged, front, q, np.zeros_like(q)], axis=1),
            np.stack([tagged, at, q, np.ones_like(q)], axis=1)[rear]])
        return rows[np.lexsort((rows[:, 1], rows[:, 0]))]
    if spec["kind"] == "every":
        # one copy every so many bases of each record, the patterns in
        # turn, each in a random orientation
        every = spec["every"]
        t, at = zip(*[(t, x) for t, L in enumerate(lengths.tolist())
                      for x in range(every, L - 2 * m, every)]) or ((), ())
        t, at = np.array(t, np.int64), np.array(at, np.int64)
        q = np.arange(len(t)) % len(patterns)
        return np.stack([t, at, q, rng.integers(2, size=len(t))], axis=1)
    raise ValueError(f"unknown kind of plants {spec['kind']!r}")
