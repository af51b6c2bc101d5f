"""Entry points of the port beside ``__graft_entry__.py``'s.

``entry(device)``   -> (fn, args): the single engine's scan and selection
                       on the flagship config (a 23 bp IUPAC pattern, 64 KiB
                       of DNA text, k=3); ``fn(*args)`` returns the (2, N)
                       [end positions; costs] candidates on the device.
``dryrun_multichip(n, device)`` -> builds an n-slot ('pat', 'text') mesh
                       on ``device`` (this process's, or every rank's of an
                       initialized process group), runs the sharded search
                       of four scenarios (overhang, the fast path, an uneven
                       tail with idle shards, a pattern count the 'pat' axis
                       does not divide) and checks each against the port's
                       single engine and the owner-computes rule.

Both default to the card, and raise without one.
"""

from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

__all__ = ["entry", "dryrun_multichip", "check_sharded_case"]


def entry(device="cuda"):
    from .ops.myers_torch import TorchEngine
    from .profiles import Iupac

    rng = np.random.default_rng(0)
    text = rng.choice(_BASES, size=1 << 16)
    pattern = rng.choice(_BASES, size=23)
    prof = Iupac()
    eng = TorchEngine(device)
    inp = eng.build_inputs(prof, prof.encode(pattern), text, k=3)

    def forward(inp):
        return eng.select(inp, eng.scan(inp))

    return forward, (inp,)


def check_sharded_case(ss, got, want, n_text: int, steps: int) -> int:
    """The sharded lists ``got`` equal ``want`` (the single engine's), and
    the owner-computes statistics of ``ss.last_stats`` balance (reference
    ``__graft_entry__.py:39-92``): no candidate from a shard that does not
    own its end, the owned-word split covers the ``n_text + steps``
    scanned positions' words once in descending S-sized slabs, and the
    per-shard counts equal ``want`` bucketed by owner. Returns the
    candidates' count."""
    for q, (cands, w) in enumerate(zip(got, want)):
        assert sorted(cands) == sorted(w), (
            f"sharded mismatch, pattern {q}: {sorted(cands)[:5]} vs "
            f"{sorted(w)[:5]}")
    stats = ss.last_stats
    S = stats["S"]
    assert stats["ownership_violations"] == 0, stats["ownership_violations"]
    owned = stats["owned_words"]
    assert sum(owned) == -(-(n_text + steps) // 32), (owned, n_text, steps)
    nz = [w for w in owned if w]
    assert nz == sorted(nz, reverse=True) and all(
        w == S for w in nz[:-1]), (owned, S)
    assert owned == nz + [0] * (len(owned) - len(nz)), owned
    span = S * 32
    want_counts = np.zeros(stats["per_shard_counts"].shape, np.int64)
    for q, w in enumerate(want):
        for pos, _cost in w:
            want_counts[q // stats["Qlocal"],
                        0 if pos <= 0 else (pos - 1) // span] += 1
    got_counts = stats["per_shard_counts"]
    assert (got_counts == want_counts).all(), (got_counts, want_counts)
    n_result = sum(len(c) for c in got)
    assert int(got_counts.sum()) == n_result, (got_counts.sum(), n_result)
    return n_result


def dryrun_multichip(n_devices: int, device="cuda") -> list[tuple]:
    """Returns (scenario, patterns, text length, alpha, candidates) per
    scenario; any disagreement raises ``AssertionError``."""
    from . import semantics
    from .ops.myers_torch import TorchEngine
    from .parallel import ShardedSearch, make_mesh
    from .profiles import Iupac

    n_pat = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    mesh = make_mesh(n_text=n_devices // n_pat, n_pat=n_pat, device=device)

    rng = np.random.default_rng(1)
    prof = Iupac()
    k = 3
    pats4 = [rng.choice(_BASES, size=16) for _ in range(4)]
    # the pattern axis padded with repeats of pattern 0
    pats_odd = [rng.choice(_BASES, size=16) for _ in range(max(3, n_pat + 1))]
    big = rng.choice(_BASES, size=n_devices * 512 + 37)
    # so short that the S >= H + 1 floor leaves trailing shards a partial
    # slab or nothing
    tiny = rng.choice(_BASES, size=150)
    scenarios = [
        ("overhang", pats4, big, 0.5),
        ("fast", pats4, big, None),
        ("uneven tail", pats4, tiny, 0.5),
        ("Q % n_pat != 0", pats_odd, big, None),
    ]
    ss = ShardedSearch(mesh=mesh)
    engine = TorchEngine(mesh.device)
    done = []
    for name, patterns, text, alpha in scenarios:
        got = ss.candidates_batch(prof, patterns, text, k, alpha=alpha)
        want = [engine.candidates(prof, prof.encode(p), text, k, alpha, None,
                                  False) for p in patterns]
        steps = semantics.overhang_steps(len(patterns[0]), k, alpha, None)
        n = check_sharded_case(ss, got, want, len(text), steps)
        done.append((name, len(patterns), len(text), alpha, n))
    return done
