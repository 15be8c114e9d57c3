"""K4 (``stjoin_sim_fused``, fused pass 2 of the dense plans; its kernel
is ``stjoin_sim_panel_fused_kernel`` over every row) against its
roofline: the least time of its jobs' work (``roofline.sim_fused``) over
its device time in the trace, in %."""
from dscbench import roofline

KIND = "per_layer"
UNIT = "%"
KERNEL = "stjoin_sim_panel_fused_kernel"


def read(run):
    plan = run.cell.plan
    if (plan.get("mode") != "fused" or plan.get("sim_mode") != "dense"
            or plan.get("use_index")):
        return None

    def bound(i):
        sl = run.slices[i]
        T, M = sl.shape
        S = T * sl.params["max_subtrajs_per_traj"]
        return roofline.sim_fused(T, M, S, *run.work[i])

    return roofline.share(run, KERNEL, bound)
