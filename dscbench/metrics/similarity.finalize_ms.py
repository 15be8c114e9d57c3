"""Milliseconds a job spends in the dense matrix's Eq. 2 normalization
(``finalize_sim``) inside ``run_dsc``'s ``similarity`` stage: the span
``similarity.finalize`` (its own CUDA events, ``stage_times=``), the mean
over the window.  A program without the span reads nothing."""
KIND = "per_layer"
UNIT = "ms"
SPAN = "similarity.finalize"


def read(run):
    v = [j.stage_ms[SPAN] for j in run.jobs
         if j.stage_ms and SPAN in j.stage_ms]
    return sum(v) / len(v) if v else None
