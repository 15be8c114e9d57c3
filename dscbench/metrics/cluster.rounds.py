"""Clustering rounds a job (``DSCOutput.rounds``, summed over the top-K
dispatches), the mean over the window."""
KIND = "per_layer"
UNIT = "count"


def read(run):
    v = [j.rounds for j in run.jobs if j.rounds is not None]
    return sum(v) / len(v) if v else None
