"""Milliseconds a job spends in ``run_dsc``'s ``cluster`` stage (its own
CUDA events, ``stage_times=``; summed over the top-K dispatches), the
mean over the window."""
KIND = "per_layer"
UNIT = "ms"
STAGE = "cluster"


def read(run):
    v = [j.stage_ms[STAGE] for j in run.jobs
         if j.stage_ms and STAGE in j.stage_ms]
    return sum(v) / len(v) if v else None
