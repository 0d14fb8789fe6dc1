"""`torch.cuda.max_memory_allocated` over set-up and window, in GB (1e9
bytes): the device memory the cell's column and its queries cost."""

UNIT = "GB"


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
