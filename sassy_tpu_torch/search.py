"""The port's :class:`Searcher`: the reference ``sassy_tpu.Searcher`` with
its engine replaced by the PyTorch/CUDA single-pattern engine.

Reverse-complement handling, the end-position filter, the N-fraction
filter, only-best selection and the CIGAR traceback are inherited
unchanged; only candidate finding runs on the device. Entry points outside
the ported slice raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import torch

from sassy_tpu import search as ref_search
from sassy_tpu.profiles import Profile, get_profile

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
        device: "cuda" runs the hand-written scan kernel (and raises
            without a CUDA device); "cpu" runs its plain PyTorch version.
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

    def search_texts(self, pattern, texts, k: int):
        _not_ported("search_texts", "Batched engine (slice 2)")

    def search_all_texts(self, pattern, texts, k: int):
        _not_ported("search_all_texts", "Batched engine (slice 2)")

    def search_patterns(self, patterns, text, k: int):
        _not_ported("search_patterns", "Batched engine (slice 2)")

    def search_many(self, patterns, texts, k: int, num_threads: int = 0,
                    mode: str = ref_search.SearchMode.AUTO):
        _not_ported("search_many", "Batched engine (slice 2)")

    def search_many_with_fn(self, patterns, texts, k, all_minima, filter_fn):
        _not_ported("search_many_with_fn", "Batched engine (slice 2)")

    def search_many_with_fn_async(self, patterns, texts, k, all_minima,
                                  filter_fn):
        _not_ported("search_many_with_fn_async", "Batched engine (slice 2)")

    def search_encoded_patterns(self, encoded, text, k: int):
        _not_ported("search_encoded_patterns", "Batched engine (slice 2)")

    def search_all_encoded_patterns(self, encoded, text, k: int):
        _not_ported("search_all_encoded_patterns", "Batched engine (slice 2)")
