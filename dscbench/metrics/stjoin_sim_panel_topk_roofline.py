"""K7 (``stjoin_sim_panel_fused_kernel`` over 128-row panels: the fused
top-K plans' pass 2, every panel of every widen pass) against its
roofline: K7's least work in one exact similarity pass of each traced job
(``roofline.sim_panel_topk``: its inputs and arithmetic, not the lists
that the panel's tail writes), summed, over the device time of every
launch in the trace, in %."""
from dscbench import roofline

KIND = "per_layer"
UNIT = "%"
KERNEL = "stjoin_sim_panel_fused_kernel"


def read(run):
    plan = run.cell.plan
    if (plan.get("mode") != "fused" or plan.get("sim_mode") != "topk"
            or plan.get("use_index")):
        return None

    def bound(i):
        T, M = run.slices[i].shape
        return roofline.sim_panel_topk(T, M, *run.work[i])

    return roofline.share_summed(run, KERNEL, bound)
