"""sassy_tpu_torch: the PyTorch / CUDA port of sassy_tpu for an NVIDIA H100.

Single-pattern approximate search (DNA or IUPAC, both strands, no
overhang) with the scan on the GPU in a hand-written CUDA kernel:

    from sassy_tpu_torch import Searcher

    searcher = Searcher("dna", rc=True, device="cuda")
    matches = searcher.search(b"ATCG", b"CCCATCACCC", k=1)

It shares the JAX-free host modules of ``sassy_tpu`` (profiles, semantics,
match records, traceback) and never imports JAX.
"""

from sassy_tpu import profiles
from sassy_tpu.cigar import Cigar
from sassy_tpu.matchrec import UNKNOWN, Match, Strand

from .search import Searcher


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
    "UNKNOWN",
    "profiles",
]
