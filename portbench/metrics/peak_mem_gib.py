"""`torch.cuda.max_memory_allocated()` over the window, reset at its start
(the weights included)."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
