"""Seconds from the process's start to the window's: imports, the CUDA
context, loading (a first run in a checkout: building) the kernels, the
slices and the warm-up jobs."""
KIND = "end_to_end"
UNIT = "s"


def read(run):
    return run.setup_s
