"""Subtrajectory join (Problem 1 / DTJ) — plain PyTorch path
(counterpart of ``repro.core.geometry``).

For every reference point ``(r, m)`` and candidate trajectory ``c``: the
candidate point inside the spatiotemporal cylinder (radius ``eps_sp``,
half-height ``eps_t``) with the highest proximity weight
``1 - d_s / eps_sp``.  This formulation tests ``d_s <= eps_sp`` on the
square root, exactly as the JAX reference does; the join kernel
(``repro_torch.kernels.stjoin``) keeps its own ``d2 <= eps_sp**2`` test.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import JoinResult, TrajectoryBatch, f32, sqrt_rn

# elements of one [rows, M, C, Mc] broadcast temporary
CHUNK_ELEMENTS = 1 << 27


def best_match_join(ref: TrajectoryBatch, cand: TrajectoryBatch, eps_sp,
                    eps_t) -> JoinResult:
    """Dense best-match spatiotemporal join; ``[T_ref, M_ref, T_cand]``.
    Pairs of points of the same trajectory id never match.

    The ``[T, M, C, Mc]`` broadcast is evaluated in chunks of reference
    rows, so the temporaries stay bounded at any batch size.
    """
    T, M = ref.x.shape
    C, Mc = cand.x.shape
    dev = ref.device
    eps_sp, eps_t = f32(eps_sp, dev), f32(eps_t, dev)
    best_w = torch.empty((T, M, C), dtype=torch.float32, device=dev)
    best_idx = torch.empty((T, M, C), dtype=torch.int32, device=dev)
    rows = max(1, CHUNK_ELEMENTS // max(M * C * Mc, 1))
    cx, cy, ct = cand.x[None, None], cand.y[None, None], cand.t[None, None]
    cok = cand.valid[None, None]
    for r0 in range(0, T, rows):
        r = slice(r0, r0 + rows)
        dx = ref.x[r, :, None, None] - cx
        dy = ref.y[r, :, None, None] - cy
        dt = (ref.t[r, :, None, None] - ct).abs()
        d_sp = sqrt_rn(dx * dx + dy * dy)
        ok = (d_sp <= eps_sp) & (dt <= eps_t)
        ok &= ref.valid[r, :, None, None] & cok
        same = ref.traj_id[r, None] == cand.traj_id[None, :]
        ok &= ~same[:, None, :, None]
        w = torch.where(ok, 1.0 - d_sp / eps_sp, 0.0)
        bw = w.amax(dim=-1)
        arg = w.argmax(dim=-1)
        best_w[r] = bw
        best_idx[r] = torch.where(bw > 0.0, arg.to(torch.int32), -1)
    return JoinResult(best_w=best_w, best_idx=best_idx)


def filter_delta_t(join: JoinResult, ref_t: torch.Tensor, delta_t) -> JoinResult:
    """DTJ Refine: drop matches whose common subsequence lasts < ``delta_t``.

    For each (ref trajectory r, candidate c) the matched reference points
    form runs of consecutive samples; a run whose time extent
    ``t[last] - t[first]`` is below ``delta_t`` is discarded.  The JAX
    package's ``.at[s].min / .max`` segment reductions are
    ``scatter_reduce("amin" / "amax")`` here.
    """
    T, M, C = join.best_w.shape
    dev = join.best_w.device
    matched_mc = (join.best_w > 0.0).permute(0, 2, 1)              # [T, C, M]
    prev = torch.nn.functional.pad(matched_mc, (1, 0))[..., :M]
    starts = matched_mc & ~prev
    run_id = torch.cumsum(starts, dim=-1) - 1
    run_id = torch.where(matched_mc, run_id, M - 1)               # park

    big = torch.finfo(torch.float32).max
    t_b = ref_t[:, None, :].expand(T, C, M)
    seg = (run_id + torch.arange(T * C, device=dev).view(T, C, 1) * M
           ).reshape(-1)
    t_min = torch.full((T * C * M,), big, dtype=torch.float32, device=dev)
    t_min = t_min.scatter_reduce(
        0, seg, torch.where(matched_mc, t_b, big).reshape(-1), "amin")
    t_max = torch.full((T * C * M,), -big, dtype=torch.float32, device=dev)
    t_max = t_max.scatter_reduce(
        0, seg, torch.where(matched_mc, t_b, -big).reshape(-1), "amax")
    keep_run = (t_max - t_min).view(T, C, M) >= f32(delta_t, dev)
    keep = torch.gather(keep_run, -1, run_id) & matched_mc
    keep = keep.permute(0, 2, 1)                                  # [T, M, C]
    return JoinResult(best_w=torch.where(keep, join.best_w, 0.0),
                      best_idx=torch.where(keep, join.best_idx, -1))


def subtrajectory_join(ref: TrajectoryBatch, cand: TrajectoryBatch, eps_sp,
                       eps_t, delta_t=0.0, *, use_index: bool = False
                       ) -> JoinResult:
    """Problem 1, end to end: cylinder join + delta_t run filtering."""
    if use_index:
        raise NotImplementedError(
            "use_index: index pruning is ROADMAP queue 1 item 8")
    j = best_match_join(ref, cand, eps_sp, eps_t)
    if float(delta_t) > 0.0:
        return filter_delta_t(j, ref.t, delta_t)
    return j
