"""K2 (``stjoin_vote_fused_kernel``, fused pass 1) against its roofline:
the least time of its jobs' work (``roofline.vote_fused``) over its device
time in the trace, in %."""
from dscbench import roofline

KIND = "per_layer"
UNIT = "%"
KERNEL = "stjoin_vote_fused_kernel"


def read(run):
    if run.cell.plan.get("mode") != "fused" or run.cell.plan.get("use_index"):
        return None

    def bound(i):
        T, M = run.slices[i].shape
        return roofline.vote_fused(T, M, *run.work[i])

    return roofline.share(run, KERNEL, bound)
