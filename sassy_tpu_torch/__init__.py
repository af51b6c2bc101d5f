"""sassy_tpu_torch: the PyTorch / CUDA port of sassy_tpu for an NVIDIA H100.

Approximate search (DNA or IUPAC, both strands, with or without overhang)
of one pattern in one text, or of many patterns in many texts in one
batched pass, with the scans on the GPU in hand-written CUDA kernels:

    from sassy_tpu_torch import Searcher

    searcher = Searcher("dna", rc=True, device="cuda")
    matches = searcher.search(b"ATCG", b"CCCATCACCC", k=1)
    matches = searcher.search_many([b"ATCG", b"GGTA"],
                                   [b"CCCATCACCC", b"TTGGTAC"], k=1)

It keeps its own copies of the host modules of ``sassy_tpu`` (profiles,
semantics, match records, traceback) and imports nothing of that package,
nor JAX.
"""

from . import profiles
from .cigar import Cigar
from .matchrec import UNKNOWN, Match, Strand
from .search import CachedRev, EncodedPatterns, SearchMode, Searcher


def features() -> dict:
    """What the port will run on: torch and CUDA versions, whether nvcc
    (which builds the scan kernel) is present, and the devices."""
    import torch

    from .ops.myers_cuda import nvcc_path

    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": cuda,
        "nvcc": nvcc_path(),
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device": torch.cuda.get_device_name(0) if cuda else None,
    }


__all__ = [
    "features",
    "Searcher",
    "Match",
    "Strand",
    "Cigar",
    "CachedRev",
    "EncodedPatterns",
    "SearchMode",
    "UNKNOWN",
    "profiles",
]
