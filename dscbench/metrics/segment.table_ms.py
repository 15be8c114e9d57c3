"""Milliseconds a job spends building the subtrajectory slot table
(``build_subtraj_table``) inside ``run_dsc``'s ``segment`` stage: the span
``segment.table`` (its own CUDA events, ``stage_times=``), the mean over
the window.  A program without the span reads nothing."""
KIND = "per_layer"
UNIT = "ms"
SPAN = "segment.table"


def read(run):
    v = [j.stage_ms[SPAN] for j in run.jobs
         if j.stage_ms and SPAN in j.stage_ms]
    return sum(v) / len(v) if v else None
