"""Multi-process plumbing of the sharded search (port of
``sassy_tpu/parallel/multihost.py``).

- ``initialize()`` wraps ``torch.distributed.init_process_group``. The
  backend is chosen per host: NCCL when this host's ranks each have a
  card of their own, gloo on a host without a card or when the caller
  asks for ranks to share cards; any other case raises;
- ``global_search()`` runs ``ShardedSearch`` over a ('pat', 'text') mesh
  of every rank's slots; every rank returns the full result;
- ``host_shard_of()`` tells a rank which contiguous slice of a list of
  items (records, files) to read.

One process with no coordinator configured needs no process group: the
search runs over this process's slots alone.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..profiles import Profile
from .sharded import ShardedSearch, make_mesh

__all__ = ["initialize", "global_search", "host_shard_of"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_rank: int | None = None,
               local_world_size: int | None = None,
               share_cards: bool = False) -> None:
    """Join the process group: ``coordinator_address`` is ``host:port`` of
    rank 0 (without it, torch's ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK`` environment). A no-op when the group is up
    already, and for one process with neither an address nor that
    environment. Failures raise.

    The backend is decided per host, from this rank's place among the
    ranks of its host: ``local_rank`` of ``local_world_size`` (else
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``, as ``torchrun`` sets them; with
    neither, every rank is on this host). NCCL when the host's ranks fit
    on its cards, one card each (local rank r takes card r); gloo on a
    host without a card, or with ``share_cards``, where local rank r takes
    card ``r % cards`` and the ranks' small tensors go through the host.
    More ranks than cards without ``share_cards`` raises."""
    if dist.is_initialized():
        return
    if (num_processes in (None, 1) and coordinator_address is None
            and "MASTER_ADDR" not in os.environ):
        return  # one process: nothing to join
    world = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    backend, card = _backend(world, rank, local_rank, local_world_size,
                             share_cards)
    if card is not None:
        torch.cuda.set_device(card)
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)


def _backend(world: int, rank: int, local_rank: int | None,
             local_world: int | None, share_cards: bool
             ) -> tuple[str, int | None]:
    """(backend, this rank's card or None) for ``initialize``."""
    if local_world is None and "LOCAL_WORLD_SIZE" in os.environ:
        local_world = int(os.environ["LOCAL_WORLD_SIZE"])
    if local_rank is None and "LOCAL_RANK" in os.environ:
        local_rank = int(os.environ["LOCAL_RANK"])
    if local_world is None:
        local_world = world  # no word of hosts: one host
    if local_rank is None:
        if local_world != world:
            raise ValueError(f"{local_world} of {world} ranks on this host: "
                             "pass local_rank or set LOCAL_RANK")
        local_rank = rank
    if not 0 <= local_rank < local_world <= world:
        raise ValueError(f"local rank {local_rank} of {local_world} on a "
                         f"host, {world} ranks in all")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        return "gloo", None
    if share_cards:
        return "gloo", local_rank % cards
    if local_world > cards:
        raise ValueError(
            f"{local_world} ranks on a host with {cards} CUDA devices: "
            "NCCL needs a card per rank; pass share_cards=True to share "
            "them over gloo")
    return "nccl", local_rank


def host_shard_of(n_items: int) -> tuple[int, int]:
    """[start, end) of the items this rank owns (contiguous split)."""
    if dist.is_initialized():
        pid, nproc = dist.get_rank(), dist.get_world_size()
    else:
        pid, nproc = 0, 1
    per = -(-n_items // nproc)
    return min(pid * per, n_items), min((pid + 1) * per, n_items)


def global_search(profile: Profile, patterns, text, k: int, n_pat: int = 1,
                  slots_per_rank: int = 1, device="cuda",
                  **kw) -> list[list[tuple[int, int]]]:
    """Sharded search over every rank of the job: ``slots_per_rank`` slots
    on each rank's ``device``, the text sharded over the mesh's 'text'
    axis and the patterns over its ``n_pat`` pattern groups. Every rank
    returns the per-pattern (end position, cost) lists, identical to the
    single-device engines'. ``kw`` goes to ``candidates_batch``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    slots = world * slots_per_rank
    if slots % n_pat:
        raise ValueError(f"{slots} slots do not split into {n_pat} pattern "
                         "groups")
    mesh = make_mesh(n_text=slots // n_pat, n_pat=n_pat, device=device)
    return ShardedSearch(mesh=mesh).candidates_batch(profile, patterns, text,
                                                     k, **kw)
