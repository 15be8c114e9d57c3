"""Peaks of the card and the least work a kernel's job needs.

A kernel's bound is ``max(bytes / peak bytes/s, operations / peak
operations/s)``, the least time any exact implementation could take on
the card.  The counts come from the inputs and parameters alone (the
reference's join of each slice), never from how a kernel sweeps:

* each input byte is read once and each output byte written once;
* the arithmetic counted is that of the point pairs that match (inside
  both eps_sp and eps_t), which any exact join has to evaluate, and of the
  best matches that its consumers take.

Peaks: NVIDIA's H100 SXM data sheet (dense, at the 700 W limit): 3.35
TB/s of HBM3, 67 TFLOP/s of float32 outside the tensor cores, that is
33.5e12 float32 instructions a second with an FMA counted as one.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 33.5e12

# float32 instructions of one matching point pair: dx, dy, dt, dx*dx,
# dy*dy, their sum, |dt|, the two threshold tests, the root, the division
# and 1 - d / eps_sp (the root and the division counted as one each)
OPS_PER_PAIR = 12
# per best match: the vote's add and the word's OR (pass 1); the
# similarity cell's add (pass 2)
OPS_PER_BEST_VOTE = 2
OPS_PER_BEST_SIM = 1
# bytes of one input point: x, y, t (float32) and its validity (bool)
POINT_BYTES = 13


def seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S)


def vote_fused(T: int, M: int, n_pairs: int, n_best: int) -> float:
    """Fused pass 1 (K2): points and trajectory ids in; a vote a point and
    the packed neighbour words (``ceil(T / 32)`` int32 a point) out."""
    W = -(-T // 32)
    nbytes = T * M * POINT_BYTES + T * 4 + T * M * 4 + T * M * W * 4
    return seconds(nbytes, OPS_PER_PAIR * n_pairs + OPS_PER_BEST_VOTE * n_best)


def sim_fused(T: int, M: int, S: int, n_pairs: int, n_best: int) -> float:
    """Fused pass 2 (K4): points, trajectory ids and the point-to-slot map
    in; the raw ``[S, S]`` float32 matrix out."""
    nbytes = T * M * (POINT_BYTES + 4) + T * 4 + S * S * 4
    return seconds(nbytes, OPS_PER_PAIR * n_pairs + OPS_PER_BEST_SIM * n_best)


def sim_panel_topk(T: int, M: int, n_pairs: int, n_best: int) -> float:
    """K7's least work in one exact similarity pass of a top-K job (every
    panel of every widen pass): points, trajectory ids and the
    point-to-slot map in once, and the arithmetic of ``sim_fused``.  Not
    the ``[S, K]`` lists, which the panel's tail writes after K7, and not
    the widen passes, which a schedule that needs fewer would not run."""
    nbytes = T * M * (POINT_BYTES + 4) + T * 4
    return seconds(nbytes, OPS_PER_PAIR * n_pairs + OPS_PER_BEST_SIM * n_best)


def share(run, kernel: str, bound) -> float | None:
    """A kernel's share of its roofline over the traced jobs, in %: the
    bounds of the jobs it ran in over its device time.  ``bound(slice
    index)`` is one launch's bound.  ``None`` without a trace, without
    launches, or when the launches do not pair one to one with the traced
    jobs."""
    if run.trace is None:
        return None
    secs = run.trace.kernel_seconds(kernel)
    if not secs or len(secs) != len(run.traced):
        return None
    return 100.0 * sum(bound(j.slice) for j in run.traced) / sum(secs)


def share_summed(run, kernel: str, bound) -> float | None:
    """A kernel that a job launches many times against its roofline over
    the traced jobs, in %: the sum of the traced jobs' bounds (``bound(slice
    index)``, one job's) over the device time of every launch in the
    trace.  ``None`` without a trace or without launches."""
    if run.trace is None or not run.traced:
        return None
    secs = run.trace.kernel_seconds(kernel)
    if not secs:
        return None
    return 100.0 * sum(bound(j.slice) for j in run.traced) / sum(secs)
