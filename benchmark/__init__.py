"""The benchmark of sassy_tpu_torch: run with ``python3 -m benchmark.run``."""
