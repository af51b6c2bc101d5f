"""The port's copies of ``examples/``: each runs as ``python -m
sassy_tpu_torch.examples.<name> [--device cuda|cpu]`` (default cuda, which
raises without a card) and exposes ``main(device=...)``."""

import argparse


def device_arg(doc: str) -> str:
    """The ``--device`` of an example's command line."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="Device to search on (default cuda; 'cpu' runs the "
                         "kernels' plain PyTorch versions)")
    return ap.parse_args().device
