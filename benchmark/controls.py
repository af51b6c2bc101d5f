"""The program under test, and the controls that stand in its place.

``program`` makes the entry the window drives: the port's ``Searcher`` as
the configuration states it. A control breaks one guarantee that the
configuration states, by a path the program has or by a cheaper search
that would tempt: the check has to find each of them not correct. The
benchmark's own runs never use a control; ``run.py --control <name>``
runs one in the program's place.
"""

from __future__ import annotations

__all__ = ["program", "CONTROLS"]


def program(config: dict, device):
    """The port's ``Searcher`` with the configuration's profile and
    strands: traceback on, no overhang, no N filter."""
    from sassy_tpu_torch.search import Searcher

    return Searcher(profile=config["profile"], rc=config["rc"],
                    device=device)


class _LowerK:
    """The program searching with k - 1 (drops the matches at cost k)."""

    def __init__(self, inner):
        self.inner = inner

    @property
    def last_finish_split(self):
        return self.inner.last_finish_split

    def search_many(self, patterns, texts, k):
        return self.inner.search_many(patterns, texts, k - 1)

    def search_many_with_fn_async(self, patterns, texts, k, all_minima,
                                  filter_fn):
        return self.inner.search_many_with_fn_async(patterns, texts, k - 1,
                                                    all_minima, filter_fn)


def _forward_only(config: dict, device):
    return program({**config, "rc": False}, device)


CONTROLS = {
    # the same search at k - 1: the cost-k matches go missing
    "k_minus_1": lambda config, device: _LowerK(program(config, device)),
    # the program's own path without the traceback: no starts, no CIGARs
    "no_trace": lambda config, device: program(config, device).without_trace(),
    # the forward strand alone: the reverse strand's matches go missing
    "forward_only": _forward_only,
}
