"""peak_device_gib (GiB, end to end): ``torch.cuda.max_memory_allocated()``
over the warm-up and the window, its count reset once the inputs were on
the host and the benchmark's own device tensors freed."""


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2**30
