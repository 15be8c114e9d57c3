"""Milliseconds a job over the window: the window (the first timed job's
start to the end of the last job started before the time ran out) over
the jobs completed in it; a job ends when its labels are on the host."""
KIND = "end_to_end"
UNIT = "ms"


def read(run):
    return run.window_s * 1e3 / len(run.jobs)
