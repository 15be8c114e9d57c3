"""Milliseconds a job spends resolving alpha and k (the row moments over
the matrix) inside ``run_dsc``'s ``cluster`` stage: the span
``cluster.thresholds`` (its own CUDA events, ``stage_times=``; summed over
the top-K dispatches), the mean over the window.  A program without the
span reads nothing."""
KIND = "per_layer"
UNIT = "ms"
SPAN = "cluster.thresholds"


def read(run):
    v = [j.stage_ms[SPAN] for j in run.jobs
         if j.stage_ms and SPAN in j.stage_ms]
    return sum(v) / len(v) if v else None
