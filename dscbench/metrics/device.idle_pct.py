"""The share of the traced window in which no operation ran on the device
(the union of the device intervals from the profiler's trace)."""
KIND = "per_layer"
UNIT = "%"


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
