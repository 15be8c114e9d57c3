"""Public wrappers: TrajectoryBatch- and array-level subtrajectory join
through the join kernels (counterpart of ``repro.kernels.stjoin.ops``:
the dense ``best_match_join_kernel`` and ``subtrajectory_join``, and the
fused streaming passes ``stjoin_vote_fused(_arrays)``,
``stjoin_sim_fused(_arrays)`` and ``stjoin_sim_panel_fused(_arrays)``; the
index-pruned variants are ROADMAP queue 1 item 8).

Dispatch is on the tensors' device: CUDA tensors launch the CUDA kernels
(``csrc/dsc_kernels.cu``: ``stjoin_best_match``, ``stjoin_vote_fused``,
``stjoin_sim_fused``, ``stjoin_sim_panel_fused``), CPU tensors take the
plain versions in ``ref.py``.
The kernels need no padding and no tile geometry: the TPU's row-aligned
blocks and word-aligned candidate blocks are a tiling constraint of the
Pallas kernels, not part of the contract.  Numerics are set out in this
package's docstring.
"""
from __future__ import annotations

import torch

from repro_torch.core.geometry import filter_delta_t
from repro_torch.core.similarity import slot_ids
from repro_torch.core.types import JoinResult, TrajectoryBatch, f32
from repro_torch.kernels import check_cuda_operands, launch
from repro_torch.kernels.stjoin.ref import (stjoin_ref, stjoin_sim_fused_ref,
                                            stjoin_sim_panel_fused_ref,
                                            stjoin_vote_fused_ref)

# shared memory an sm_90 block can opt into, less the sweep's static
# candidate staging (the K2 / K4 row tiles are dynamic shared memory)
_DYN_SMEM_MAX = 232448 - 13728
_INDEX_ITEM = ("use_index: the pruned fused kernels (K11, K12) are ROADMAP "
               "queue 1 item 8")
_PANEL_INDEX_ITEM = ("use_index: the pruned panel kernel (K13) is ROADMAP "
                     "queue 1 item 8")


def _flat_operands(rx, ry, rt, rvalid, rid, cx, cy, ct, cvalid, cid):
    """Kernel operand order: ref x, y, t, id, ok flattened to ``[T*M]``
    (the id repeated per point), then cand x, y, t, id, ok."""
    T, M = rx.shape
    flat = lambda a: a.contiguous().view(-1)
    rid_p = rid.to(torch.int32)[:, None].expand(T, M)
    return ((flat(rx), flat(ry), flat(rt), flat(rid_p), flat(rvalid)),
            (cx.contiguous(), cy.contiguous(), ct.contiguous(),
             cid.to(torch.int32).contiguous(), cvalid.contiguous()))


def _eps(*v):
    return tuple(float(f32(x, "cpu")) for x in v)


def stjoin_best_match(ref_x, ref_y, ref_t, ref_id, ref_ok,
                      cand_x, cand_y, cand_t, cand_id, cand_ok, eps_sp,
                      eps_t, *, out_w=None, out_idx=None):
    """``(best_w [P, C] f32, best_idx [P, C] i32)`` — the K1 contract.

    ``out_w`` / ``out_idx`` may name ``[P, C]`` views to write into.
    """
    if not ref_x.is_cuda:
        w, idx = stjoin_ref(ref_x, ref_y, ref_t, ref_id, ref_ok, cand_x,
                            cand_y, cand_t, cand_id, cand_ok, eps_sp, eps_t)
        if out_w is not None:
            out_w.copy_(w)
            out_idx.copy_(idx)
            return out_w, out_idx
        return w, idx
    P = ref_x.shape[0]
    C, Mc = cand_x.shape
    f, i, b = torch.float32, torch.int32, torch.bool
    dev = check_cuda_operands(
        "stjoin_best_match", ref_x=(ref_x, f), ref_y=(ref_y, f),
        ref_t=(ref_t, f), ref_id=(ref_id, i), ref_ok=(ref_ok, b),
        cand_x=(cand_x, f), cand_y=(cand_y, f), cand_t=(cand_t, f),
        cand_id=(cand_id, i), cand_ok=(cand_ok, b))
    if (C + 31) // 32 > 65535:
        raise ValueError(f"stjoin_best_match: C={C} exceeds the grid")
    if out_w is None:
        out_w = torch.empty((P, C), dtype=f, device=dev)
        out_idx = torch.empty((P, C), dtype=i, device=dev)
    check_cuda_operands("stjoin_best_match", ref_x=(ref_x, f),
                        out_w=(out_w, f), out_idx=(out_idx, i))
    if out_w.shape != (P, C) or out_idx.shape != (P, C):
        raise ValueError("stjoin_best_match: outputs must be [P, C]")
    ops = (ref_x, ref_y, ref_t, ref_id, ref_ok, cand_x, cand_y, cand_t,
           cand_id, cand_ok)
    launch("stjoin_best_match", *(t.data_ptr() for t in ops), P, C, Mc,
           *_eps(eps_sp, eps_t), out_w.data_ptr(), out_idx.data_ptr(),
           device=dev)
    return out_w, out_idx


def best_match_join_kernel(ref: TrajectoryBatch, cand: TrajectoryBatch,
                           eps_sp, eps_t) -> JoinResult:
    """Dense best-match join through K1: ``JoinResult [T, M, C]``."""
    T, M = ref.x.shape
    C = cand.x.shape[0]
    best_w = torch.empty((T, M, C), dtype=torch.float32, device=ref.device)
    best_idx = torch.empty((T, M, C), dtype=torch.int32, device=ref.device)
    ref_ops, cand_ops = _flat_operands(
        ref.x, ref.y, ref.t, ref.valid, ref.traj_id, cand.x, cand.y, cand.t,
        cand.valid, cand.traj_id)
    stjoin_best_match(*ref_ops, *cand_ops, eps_sp, eps_t,
                      out_w=best_w.view(T * M, C),
                      out_idx=best_idx.view(T * M, C))
    return JoinResult(best_w=best_w, best_idx=best_idx)


def subtrajectory_join(ref: TrajectoryBatch, cand: TrajectoryBatch,
                       eps_sp, eps_t, delta_t=0.0, *,
                       use_index: bool = False) -> JoinResult:
    """Kernel-backed Problem 1 (join + delta_t refine)."""
    if use_index:
        raise NotImplementedError(
            "use_index: the pruned join kernel (K10) is ROADMAP queue 1 "
            "item 8")
    j = best_match_join_kernel(ref, cand, eps_sp, eps_t)
    if float(delta_t) > 0.0:
        return filter_delta_t(j, ref.t, delta_t)
    return j


# ---------------------------------------------------------------------------
# Fused streaming join: the [T, M, C] cube is never built.  Pass 1
# (``stjoin_vote_fused``, K2) returns the vote sums and the packed TSA2
# neighbor words; pass 2 (``stjoin_sim_fused``, K4) re-sweeps the join after
# segmentation and scatters the refined weights into the raw similarity
# accumulator.  Both run the delta_t refine inside the kernel.
# ---------------------------------------------------------------------------


def _check_fused(name, ref_ops, cand_ops, M: int, smem: int):
    """Operand checks of K2 / K4; ``smem`` is the kernel's dynamic shared
    memory (the ``[M][33]`` row tile(s) of ``dsc_kernels.cu``)."""
    f, i, b = torch.float32, torch.int32, torch.bool
    dev = check_cuda_operands(
        name, ref_x=(ref_ops[0], f), ref_y=(ref_ops[1], f),
        ref_t=(ref_ops[2], f), ref_id=(ref_ops[3], i), ref_ok=(ref_ops[4], b),
        cand_x=(cand_ops[0], f), cand_y=(cand_ops[1], f),
        cand_t=(cand_ops[2], f), cand_id=(cand_ops[3], i),
        cand_ok=(cand_ops[4], b))
    if smem > _DYN_SMEM_MAX:
        raise ValueError(f"{name}: the row tile ({smem} bytes for M={M}) "
                         "exceeds one block's shared memory")
    return dev


def stjoin_vote_fused_arrays(rx, ry, rt, rvalid, rid, cx, cy, ct, cvalid,
                             cid, eps_sp, eps_t, delta_t=0.0, *,
                             tile_ids=None, with_masks: bool = True):
    """Fused pass 1 on raw arrays: ``(vote [T, M], words [T, M, ceil(C/32)])``.

    Subsumes ``voting.point_voting`` and ``voting.neighbor_mask_packed``
    over a delta_t-refined join without materializing it.  Words are int32
    bit patterns, bits past C zero.  ``with_masks=False`` (TSA1) returns
    ``(vote, None)`` and writes no words.
    """
    if tile_ids is not None:
        raise NotImplementedError(_INDEX_ITEM)
    T, M = rx.shape
    C, Mc = cx.shape
    ref_ops, cand_ops = _flat_operands(rx, ry, rt, rvalid, rid, cx, cy, ct,
                                       cvalid, cid)
    if not rx.is_cuda:
        vote, words = stjoin_vote_fused_ref(
            *ref_ops, *cand_ops, eps_sp, eps_t, delta_t, M=M,
            with_words=with_masks)
    else:
        dev = _check_fused("stjoin_vote_fused", ref_ops, cand_ops, M,
                           M * 34 * 4)
        W = -(-C // 32)
        vote = torch.empty((T * M,), dtype=torch.float32, device=dev)
        words = (torch.empty((T * M, W), dtype=torch.int32, device=dev)
                 if with_masks else None)
        launch("stjoin_vote_fused", *(t.data_ptr() for t in ref_ops),
               *(t.data_ptr() for t in cand_ops), T, M, C, Mc,
               *_eps(eps_sp, eps_t, delta_t), vote.data_ptr(),
               None if words is None else words.data_ptr(), W, device=dev)
    return (vote.view(T, M),
            None if words is None else words.view(T, M, -1))


def stjoin_vote_fused(ref: TrajectoryBatch, cand: TrajectoryBatch, eps_sp,
                      eps_t, delta_t=0.0, *, use_index: bool = False,
                      with_masks: bool = True):
    """Batch-level fused pass 1 (vote sums + packed neighbor words)."""
    if use_index:
        raise NotImplementedError(_INDEX_ITEM)
    return stjoin_vote_fused_arrays(
        ref.x, ref.y, ref.t, ref.valid, ref.traj_id, cand.x, cand.y, cand.t,
        cand.valid, cand.traj_id, eps_sp, eps_t, delta_t,
        with_masks=with_masks)


def _check_block_slots(ref_gid, cand_gid, ms: int, n_src: int, n_dst: int,
                       name: str = "stjoin_sim_fused"):
    """The slot contract of K4 and K7: the slots of reference row t lie in
    ``[t*ms, (t+1)*ms)``, those of candidate c in ``[c*ms, (c+1)*ms)``,
    or are the sentinels ``n_src`` / ``n_dst``."""
    T, C = ref_gid.shape[0], cand_gid.shape[0]
    if T * ms != n_src or C * ms != n_dst:
        raise ValueError(f"{name}: n_src={n_src}, n_dst={n_dst} "
                         f"are not T*ms, C*ms for T={T}, C={C}")
    dev = ref_gid.device
    in_block = lambda g, n, k: ((g == n) | (torch.div(
        g, max(ms, 1), rounding_mode="floor") == torch.arange(
            k, device=dev)[:, None])).all()
    if not bool(in_block(ref_gid, n_src, T) & in_block(cand_gid, n_dst, C)):
        raise ValueError(f"{name}: a slot lies outside its "
                         "trajectory's block of ms slots")


def stjoin_sim_fused_arrays(rx, ry, rt, rvalid, rid, ref_gid, cx, cy, ct,
                            cvalid, cid, cand_gid, n_src: int, n_dst: int,
                            eps_sp, eps_t, delta_t=0.0, *, tile_ids=None):
    """Fused pass 2 on raw arrays: raw similarity scatter ``[n_src, n_dst]``.

    ``ref_gid [T, M]``: destination row of each ref point (``n_src`` =
    sentinel).  ``cand_gid [C, Mc]``: destination column of each candidate
    point (``n_dst`` = sentinel).  Normalization is left to
    ``similarity.finalize_sim``.  On the card the slot maps must be the
    DSC ones (``n_src = T*ms``, row t's slots in ``[t*ms, (t+1)*ms)``,
    likewise for candidates), which lets each (row, candidate) pair own
    one ``ms x ms`` block of ``raw``; anything else raises.
    """
    if tile_ids is not None:
        raise NotImplementedError(_INDEX_ITEM)
    T, M = rx.shape
    C, Mc = cx.shape
    ref_ops, cand_ops = _flat_operands(rx, ry, rt, rvalid, rid, cx, cy, ct,
                                       cvalid, cid)
    ref_gid = ref_gid.to(torch.int32).contiguous()
    cand_gid = cand_gid.to(torch.int32).contiguous()
    if not rx.is_cuda:
        return stjoin_sim_fused_ref(
            *ref_ops, ref_gid.view(-1), *cand_ops, cand_gid, eps_sp, eps_t,
            delta_t, M=M, n_src=n_src, n_dst=n_dst)
    ms = n_src // max(T, 1)
    _check_block_slots(ref_gid, cand_gid, ms, n_src, n_dst)
    dev = _check_fused("stjoin_sim_fused", ref_ops, cand_ops, M,
                       (2 * M * 33 + 32 * (ms * ms + 1)) * 4)
    check_cuda_operands("stjoin_sim_fused", ref_x=(ref_ops[0], torch.float32),
                        ref_gid=(ref_gid, torch.int32),
                        cand_gid=(cand_gid, torch.int32))
    if (C + 31) // 32 > 65535:
        raise ValueError(f"stjoin_sim_fused: C={C} exceeds the grid")
    raw = torch.empty((n_src, n_dst), dtype=torch.float32, device=dev)
    launch("stjoin_sim_fused", *(t.data_ptr() for t in ref_ops),
           *(t.data_ptr() for t in cand_ops), ref_gid.data_ptr(),
           cand_gid.data_ptr(), T, M, C, Mc, ms,
           *_eps(eps_sp, eps_t, delta_t), raw.data_ptr(), device=dev)
    return raw


def stjoin_sim_fused(ref: TrajectoryBatch, cand: TrajectoryBatch,
                     ref_sub_local, cand_sub_local, max_subs: int, eps_sp,
                     eps_t, delta_t=0.0, *, tile_ids=None):
    """Batch-level fused pass 2: un-normalized ``raw [S_ref, S_cand]``.

    Ref point (r, m) scatters into row ``r * max_subs + sub_local[r, m]``;
    the matched candidate point (c, best_idx) into column
    ``c * max_subs + cand_sub_local[c, idx]``.
    """
    n_src, n_dst = ref.num_trajs * max_subs, cand.num_trajs * max_subs
    return stjoin_sim_fused_arrays(
        ref.x, ref.y, ref.t, ref.valid, ref.traj_id,
        slot_ids(ref_sub_local, max_subs, n_src), cand.x, cand.y, cand.t,
        cand.valid, cand.traj_id, slot_ids(cand_sub_local, max_subs, n_dst),
        n_src, n_dst, eps_sp, eps_t, delta_t, tile_ids=tile_ids)


def stjoin_sim_panel_fused_arrays(rx, ry, rt, rvalid, rid, ref_gid, cx, cy,
                                  ct, cvalid, cid, cand_gid, n_src: int,
                                  n_dst: int, eps_sp, eps_t, delta_t, p0, *,
                                  panel: int, tile_ids=None):
    """Fused pass 2 for one panel of ``panel`` slots, in both orientations:
    ``(fwd [panel, n_dst], rev [panel, n_src])`` with ``fwd[i, j] =
    raw[p0 + i, j]`` and ``rev[i, j] = raw[j, p0 + i]`` of the ``raw``
    that ``stjoin_sim_fused_arrays`` builds, bit for bit.

    On the card (K7) the slot maps must be the DSC block maps, as for K4;
    then only the rows and the candidates that own a panel slot are swept,
    about ``2 * panel / ms`` trajectories against all, instead of all
    against all.  The panel may split a trajectory's slots.
    """
    if tile_ids is not None:
        raise NotImplementedError(_PANEL_INDEX_ITEM)
    T, M = rx.shape
    C, Mc = cx.shape
    p0 = int(p0)
    if p0 < 0 or panel < 1 or p0 + panel > min(n_src, n_dst):
        raise ValueError(f"stjoin_sim_panel_fused: panel [{p0}, "
                         f"{p0 + panel}) is outside the {n_src} x {n_dst} "
                         "slots")
    ref_ops, cand_ops = _flat_operands(rx, ry, rt, rvalid, rid, cx, cy, ct,
                                       cvalid, cid)
    ref_gid = ref_gid.to(torch.int32).contiguous()
    cand_gid = cand_gid.to(torch.int32).contiguous()
    if not rx.is_cuda:
        return stjoin_sim_panel_fused_ref(
            *ref_ops, ref_gid.view(-1), *cand_ops, cand_gid, eps_sp, eps_t,
            delta_t, M=M, n_src=n_src, n_dst=n_dst, p0=p0, panel=panel)
    ms = n_src // max(T, 1)
    _check_block_slots(ref_gid, cand_gid, ms, n_src, n_dst,
                       name="stjoin_sim_panel_fused")
    dev = _check_fused("stjoin_sim_panel_fused", ref_ops, cand_ops, M,
                       (2 * M * 33 + 32 * (ms * ms + 1)) * 4)
    check_cuda_operands("stjoin_sim_panel_fused",
                        ref_x=(ref_ops[0], torch.float32),
                        ref_gid=(ref_gid, torch.int32),
                        cand_gid=(cand_gid, torch.int32))
    fwd = torch.empty((panel, n_dst), dtype=torch.float32, device=dev)
    rev = torch.empty((panel, n_src), dtype=torch.float32, device=dev)
    launch("stjoin_sim_panel_fused", *(t.data_ptr() for t in ref_ops),
           *(t.data_ptr() for t in cand_ops), ref_gid.data_ptr(),
           cand_gid.data_ptr(), T, M, C, Mc, ms, p0, panel,
           *_eps(eps_sp, eps_t, delta_t), fwd.data_ptr(), rev.data_ptr(),
           device=dev)
    return fwd, rev


def stjoin_sim_panel_fused(ref: TrajectoryBatch, cand: TrajectoryBatch,
                           ref_sub_local, cand_sub_local, max_subs: int,
                           eps_sp, eps_t, delta_t=0.0, *, p0, panel: int,
                           tile_ids=None):
    """Batch-level panel pass 2 (cf. ``stjoin_sim_fused``): the two raw
    orientations of the rows ``[p0, p0 + panel)`` that
    ``core.similarity.topk_stream`` finalizes."""
    n_src, n_dst = ref.num_trajs * max_subs, cand.num_trajs * max_subs
    return stjoin_sim_panel_fused_arrays(
        ref.x, ref.y, ref.t, ref.valid, ref.traj_id,
        slot_ids(ref_sub_local, max_subs, n_src), cand.x, cand.y, cand.t,
        cand.valid, cand.traj_id, slot_ids(cand_sub_local, max_subs, n_dst),
        n_src, n_dst, eps_sp, eps_t, delta_t, p0, panel=panel,
        tile_ids=tile_ids)
