"""The sharded multi-device search (port of ``sassy_tpu/parallel``)."""

from .sharded import Mesh, ShardedSearch, ShardedText, make_mesh

__all__ = ["Mesh", "ShardedSearch", "ShardedText", "make_mesh"]
