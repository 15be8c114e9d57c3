"""The device's allocation peak over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), in GB:
whether a user's slice fits."""
KIND = "end_to_end"
UNIT = "GB"


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
