"""Device layer of the PyTorch port: planning, the torch pipeline, the
selection, the batched engine, and the hand-written CUDA scan kernels."""
