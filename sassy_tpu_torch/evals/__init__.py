"""The evals harness of the port: ``python -m
sassy_tpu_torch.evals.bench_suite`` (see that module)."""
