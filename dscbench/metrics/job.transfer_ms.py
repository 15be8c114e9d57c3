"""Device milliseconds a job spends copying: the slice to the card and the
labels back (CUDA events around the copies), the mean over the window."""
KIND = "per_layer"
UNIT = "ms"


def read(run):
    v = [j.transfer_ms for j in run.jobs if j.transfer_ms is not None]
    return sum(v) / len(v) if v else None
