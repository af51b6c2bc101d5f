"""Device layer of the PyTorch port: planning, the torch pipeline, the
selection, and the hand-written CUDA scan kernel."""
