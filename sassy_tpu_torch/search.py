"""The port's :class:`Searcher`: the reference ``sassy_tpu.Searcher`` with
its engines replaced by the PyTorch/CUDA single-pattern engine and the
batched engine.

Reverse-complement handling, the end-position filter, the N-fraction
filter, only-best selection, the encoded-pattern API and the CIGAR
traceback are inherited unchanged; only candidate finding runs on the
device. Entry points outside the ported slices raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import torch

from sassy_tpu import search as ref_search
from sassy_tpu.profiles import Profile, as_bytes_array, get_profile

from .ops.batch import BatchEngine, TextSet
from .ops.myers_torch import TorchEngine

__all__ = ["Searcher"]


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to sassy_tpu_torch yet: ROADMAP.md, Queue 1, "
        f"{item!r}"
    )


class Searcher(ref_search.Searcher):
    """Approximate string searcher on a PyTorch device.

    Args:
        profile: ``Dna()``, ``Iupac()`` or their names.
        rc: also search the reverse-complement strand.
        alpha: overhang; not ported yet, must be None.
        device: "cuda" runs the hand-written scan kernels (and raises
            without a CUDA device); "cpu" runs their plain PyTorch versions.
        max_n_frac: N-fraction filter, as in the reference.
    """

    def __init__(self, profile: Profile | str, rc: bool = False,
                 alpha: float | None = None, device="cuda",
                 max_n_frac: float | None = None):
        if isinstance(profile, str):
            profile = get_profile(profile)
        if profile.eq_mode == "ascii":
            _not_ported("the ascii profile", "ascii profile")
        if alpha is not None:
            _not_ported("overhang (alpha)", "Overhang on the single path")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Searcher(device='cuda'): no CUDA device")
        super().__init__(profile, rc=rc, max_n_frac=max_n_frac)
        self.device = device
        self.engine = TorchEngine(device)
        self.batch = BatchEngine(device)

    # the reference's builders construct the reference class
    @staticmethod
    def new_fwd(profile: Profile, **kw) -> "Searcher":
        return Searcher(profile, rc=False, **kw)

    @staticmethod
    def new_rc(profile: Profile, **kw) -> "Searcher":
        return Searcher(profile, rc=True, **kw)

    @staticmethod
    def new_fwd_with_overhang(profile: Profile, alpha: float, **kw):
        return Searcher(profile, rc=False, alpha=alpha, **kw)

    @staticmethod
    def new_rc_with_overhang(profile: Profile, alpha: float, **kw):
        return Searcher(profile, rc=True, alpha=alpha, **kw)

    def with_overhang(self, alpha: float):
        _not_ported("overhang (alpha)", "Overhang on the single path")

    def _batch_engine(self):
        return self.batch

    # The reference falls back to its pairwise loop when the batched engine
    # raises; in the port that loop would run the single-pattern kernel per
    # pair and hide the batched one, so an error propagates instead.

    def _search_many_impl(self, patterns, texts, k: int, all_minima: bool,
                          rc: bool | None = None, filter_fn=None):
        return self._search_many_batched(
            [as_bytes_array(p) for p in patterns],
            [ref_search._as_rc_searchable(t) for t in texts],
            k, all_minima, self.rc if rc is None else rc, filter_fn,
        )

    def search_many_with_fn_async(self, patterns, texts, k: int,
                                  all_minima: bool, filter_fn):
        return self._search_many_batched_async(
            [as_bytes_array(p) for p in patterns],
            [ref_search._as_rc_searchable(t) for t in texts],
            k, all_minima, self.rc, filter_fn,
        )

    def _search_many_batched_async(self, pats, rc_texts, k: int,
                                   all_minima: bool, rc: bool,
                                   filter_fn=None):
        """The reference's, with the port's TextSet: one upload of the
        texts serves both strands (the reference's builds
        ``sassy_tpu.ops.batch.TextSet``, whose module imports the
        reference engines)."""
        prof = self.profile
        pcodes = [prof.encode(p) for p in pats]
        fwd_texts = [t.text() for t in rc_texts]
        ts = TextSet(fwd_texts, self.device)
        # both strands dispatch back to back; finish() fetches both
        fin = self.batch.candidates_many_async(prof, pcodes, ts, k,
                                               all_minima=all_minima)
        rfin = comp = ccodes = None
        if rc:
            comp = [as_bytes_array(prof.complement(p)) for p in pats]
            ccodes = [prof.encode(c) for c in comp]
            rfin = self.batch.candidates_many_async(
                prof, ccodes, ts, k, all_minima=all_minima, reverse=True
            )
        return lambda: self._finish_many_batched(
            fin, rfin, pats, pcodes, comp, ccodes, rc_texts, fwd_texts,
            k, filter_fn,
        )
