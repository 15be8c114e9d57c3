"""Milliseconds a job spends in the clustering round loop (a K5 launch
and a host sync a round) inside ``run_dsc``'s ``cluster`` stage: the span
``cluster.round_loop`` (its own CUDA events, ``stage_times=``; summed over
the top-K dispatches), the mean over the window.  A program without the
span reads nothing."""
KIND = "per_layer"
UNIT = "ms"
SPAN = "cluster.round_loop"


def read(run):
    v = [j.stage_ms[SPAN] for j in run.jobs
         if j.stage_ms and SPAN in j.stage_ms]
    return sum(v) / len(v) if v else None
