"""The 95th percentile of the window's job walls on the host clock (copy
in, ``run_dsc``, labels on the host).  The cell's window has to hold 200
jobs or more, so that ten lie beyond it."""
import numpy as np

KIND = "end_to_end"
UNIT = "ms"


def read(run):
    return float(np.percentile([j.wall_ms for j in run.jobs], 95))
