"""Distributed Subtrajectory Clustering — the paper's two MapReduce jobs as
one program per rank of a ``(part, model)`` mesh (counterpart of
``repro.core.distributed``).

Mesh axes (``repro_torch.distributed.mesh``):

``part``  : temporal partitions (the paper's equi-depth bins).
``model`` : candidate-trajectory parallelism — the best-match tensor
            ``B[point, cand_traj]`` is column-sharded; votes and
            similarity column blocks are summed or gathered over it.

Phases (methods of ``_DSCProgramBuilder``; every rank runs all of them,
the collectives of ``MeshComm`` between them):

  1. JOIN        halo exchange of the neighbor partition slabs
                 (``ppermute``), best-match join (K1, the fused pass K2 or
                 the plain join), delta_t refine, vote ``psum`` over
                 ``model``.
  2. REGROUP     ``all_to_all`` over ``part``: partition slabs [T, Mp] ->
                 the shard's whole trajectories [T/P, P*Mp]; valid points
                 compacted to a prefix (a stable sort).
  3. SEGMENT     TSA1 / TSA2 (K3) on whole trajectories (Job 1's reduce);
                 the table ``all_gather``; labels back through the
                 inverse ``all_to_all`` and the label halo.
  4. SIMILARITY  this rank's ``[S, S_loc]`` column block of the raw SP
                 scatter (the cube's ordered scatter, or K4), then dense
                 (the blocks' ``all_gather`` over ``model``) or top-K
                 (transpose exchange, per-rank top-(K+1), k-way merge).
  5. CLUSTER     Algorithm 4 per partition (K5 / K6, or K8 / K9 on the
                 lists), thresholds from the ``model``-summed moments.
  6. REFINE      one packed ``[4, S]`` ``all_gather`` over ``part`` and
                 the Algorithm 5 case table: one global result on every
                 rank.

Both dense strategies, ``sim_strategy="psum"`` and ``"allgather"``,
assemble ``raw`` by one model-axis gather of the ranks' ``[S, S_loc]``
column blocks.  The reference's psum places each block in a zero ``[S,
S]`` matrix and sums: every cell is non-zero on one rank at most, so the
sum is the concatenation, at ``M`` times the bytes.  The strategy stays a
plan field.  (The reference's fused psum also passes the unsliced slot
map, which misplaces candidate points on model ranks above 0; the port
builds every block with the rank's local slots.)

``build_dsc_program`` returns the per-rank body (``body.front``, phases
1-3, then ``body.back``, phases 4-6); ``run_dsc_distributed`` runs that
body (spawning the ranks, or on this rank when the mesh's process group
is up; its top-K widen loop reruns ``body.back`` only, as ``run_dsc``'s
loop reruns the stages that read K), and ``build_dsc_stage_programs``
gives one function per stage boundary over the same phase methods, so a
chain of the stages gives the monolith's outputs bit for bit.  The ring schedules (``halo_stream`` /
``sim_exchange = "ring"``) exchange the same blocks as their barrier twins
in ``ppermute`` steps and give the same bits; the halo is exchanged before
the join in both.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.core import segmentation as seg_mod
from repro_torch.core.clustering import cluster
from repro_torch.core.geometry import filter_delta_t
from repro_torch.core.partitioning import PartitionedBatch
from repro_torch.core.plan import EnginePlan, resolve_plan
from repro_torch.core.refine import refine_states
from repro_torch.core.similarity import (ROW_CHUNK, build_subtraj_table_arrays,
                                         finalize_sim, finalize_sim_cols,
                                         merge_topk_blocks, merge_topk_lists,
                                         scatter_raw, sim_row_moments,
                                         topk_overflow)
from repro_torch.core.types import (ClusteringResult, DSCParams, JoinResult,
                                    SubtrajTable, TopKSim, f32)
from repro_torch.core.voting import (PACK_ROWS, normalized_voting,
                                     point_voting)
from repro_torch.core.windows import pack_bits
from repro_torch.distributed import mesh as mesh_mod
from repro_torch.distributed.mesh import Mesh, MeshComm

_ON_OVERFLOW = ("raise", "widen", "degrade")


@dataclasses.dataclass
class DistributedDSCOutput:
    result: ClusteringResult      # [S] global, replicated
    table: SubtrajTable           # [S] global, replicated
    vote: torch.Tensor            # [P, T, Mp] partition layout
    active: torch.Tensor          # [P, S] subtraj-in-partition masks
    sim_diag: torch.Tensor        # [P, 4] (mean sim>0, alpha, k, top-K
                                  # overflow count) per partition


def _ring_gather(comm: MeshComm, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Forwarding-ring ``all_gather``: ``n - 1`` ``ppermute`` hops, each
    rank passing on the block it received last, assembled into the stack
    ``all_gather`` returns (pure data movement: the same bits)."""
    n = comm.axis_size(axis)
    if n == 1:
        return x[None].clone()
    r = comm.axis_index(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    out[r] = x
    buf = x
    for s in range(1, n):
        buf = comm.ppermute(buf, axis, perm)
        # after s hops the buffer holds rank (r - s)'s block
        out[(r - s) % n] = buf
    return out


def _top_k(x: torch.Tensor, kk: int):
    """``lax.top_k`` of each row: the ``kk`` largest values, descending,
    ties by ascending column (a stable descending sort, in row chunks)."""
    R = x.shape[0]
    vals = torch.empty((R, kk), dtype=x.dtype, device=x.device)
    idx = torch.empty((R, kk), dtype=torch.int32, device=x.device)
    for r0 in range(0, R, ROW_CHUNK):
        r = slice(r0, r0 + ROW_CHUNK)
        v, i = torch.sort(x[r], dim=1, descending=True, stable=True)
        vals[r] = v[:, :kk]
        idx[r] = i[:, :kk].to(torch.int32)
    return vals, idx


def _pack_table(t: SubtrajTable) -> torch.Tensor:
    """The gathered table fields as one ``[5, S_l]`` f32 payload (card as
    its bits, valid as 0 / 1)."""
    return torch.stack([t.t_start, t.t_end, t.voting,
                        t.card.view(torch.float32), t.valid.float()])


class _DSCProgramBuilder:
    """Mesh geometry and the six phase bodies, shared by the monolithic
    program and the per-stage programs.  ``timer`` (a ``StageTimer``, or
    ``None``) times the phases on this rank."""

    def __init__(self, parts: PartitionedBatch, params: DSCParams,
                 mesh: Mesh, part_axis: str, model_axis: str,
                 plan: EnginePlan, comm: MeshComm, timer=None):
        self.params = params
        self.mesh = mesh
        self.comm = comm
        self.part_axis = part_axis
        self.model_axis = model_axis
        self.plan = plan
        self.mode = plan.mode
        self.use_kernel = plan.use_kernel
        self.use_index = plan.use_index
        self.sim_strategy = plan.sim_strategy
        self.sim_dtype = plan.sim_dtype
        self.halo_stream = plan.halo_stream
        self.sim_exchange = plan.sim_exchange
        self.cluster_engine = plan.cluster_engine
        self.cluster_use_kernel = plan.cluster_use_kernel
        self.seg_use_kernel = plan.seg_use_kernel
        self.sim_mode = plan.sim_mode
        self.sim_topk = plan.sim_topk if plan.sim_topk is not None else 32
        self.nP = mesh.shape[part_axis]
        self.nM = mesh.shape[model_axis]
        Pn, T, Mp = parts.x.shape
        assert Pn == self.nP, f"partitions {Pn} != mesh axis {self.nP}"
        assert T % self.nP == 0, f"T={T} must divide partitions {self.nP}"
        assert T % self.nM == 0, f"T={T} must divide model axis {self.nM}"
        self.T, self.Mp = T, Mp
        self.maxS = params.max_subtrajs_per_traj
        self.S = T * self.maxS
        self.Tl = T // self.nP       # home trajectories per shard
        self.Tc = T // self.nM       # candidate columns per model rank
        self.Mtot = self.nP * Mp     # full per-trajectory point capacity
        self.dev = comm.device
        self.timer = timer

    # ------------------------------------------------------------ helpers
    @contextlib.contextmanager
    def span(self, name: str):
        """Time phase ``name`` on this rank; collectives inside it are
        recorded under its name.  Ranks that share one card hand their
        cached blocks back after each phase, so that one rank's cache
        does not hold memory the others need."""
        self.comm.phase = name
        with (contextlib.nullcontext() if self.timer is None
              else self.timer.stage(name)):
            yield
        if self.comm.host:
            torch.cuda.empty_cache()

    def local(self, a: torch.Tensor) -> torch.Tensor:
        """This rank's partition of a ``[P, ...]`` array, on its device."""
        return a[self.comm.axis_index(self.part_axis)].to(self.dev)

    def nbr(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """Slab of the partition at distance ``-shift``; zeros at the
        edge."""
        n = self.nP
        perm = [(i, i + shift) for i in range(n) if 0 <= i + shift < n]
        return self.comm.ppermute(x, self.part_axis, perm)

    def halo(self, arr):
        return self.nbr(arr, +1), self.nbr(arr, -1)

    def _gather_model(self, x, schedule):
        """Model-axis gather under the named schedule: ``"barrier"`` /
        ``"allgather"`` one ``all_gather``, ``"ring"`` the forwarding ring
        (the same stack)."""
        if schedule == "ring":
            return _ring_gather(self.comm, x, self.model_axis)
        return self.comm.all_gather(x, self.model_axis)

    def _cand_slice(self):
        """(c0, slicer) of this model rank's candidate rows."""
        c0 = self.comm.axis_index(self.model_axis) * self.Tc
        return c0, (lambda a: a[c0:c0 + self.Tc])

    def psum_model(self, x):
        return self.comm.psum(x, self.model_axis)

    def halo_points(self, px, py, pt, pv, rng):
        """Phase 1 front half: the neighbor slab exchange (with the index
        pruning and the partition time-range mask) -> ``[T, 3Mp]``
        concatenations and the per-slab views (own, left, right)."""
        params, nP = self.params, self.nP
        lxyt, rxyt = self.halo(torch.stack([px, py, pt]))
        (lx, ly, lt), (rx, ry, rt) = lxyt, rxyt
        if self.use_index:
            # index-pruned halo: exchange eps-expanded partition bboxes
            # first, then ship each neighbor only the points it can match
            inf = float("inf")
            own_box = torch.stack([
                torch.where(pv, px, inf).min(),
                torch.where(pv, px, -inf).max(),
                torch.where(pv, py, inf).min(),
                torch.where(pv, py, -inf).max(),
                torch.where(pv, pt, inf).min(),
                torch.where(pv, pt, -inf).max(),
            ])
            box_l = self.nbr(own_box, +1)      # bbox of rank - 1
            box_r = self.nbr(own_box, -1)      # bbox of rank + 1
            e_sp = f32(params.eps_sp, self.dev)
            e_t = f32(params.eps_t, self.dev)

            def inside(box):
                return ((px >= box[0] - e_sp) & (px <= box[1] + e_sp)
                        & (py >= box[2] - e_sp) & (py <= box[3] + e_sp)
                        & (pt >= box[4] - e_t) & (pt <= box[5] + e_t))

            lv = self.nbr(pv & inside(box_r), +1)
            rv = self.nbr(pv & inside(box_l), -1)
        else:
            lv, rv = self.halo(pv)
        eps_t = f32(params.eps_t, self.dev)
        lo, hi = rng[0] - eps_t, rng[1] + eps_t
        lv = lv & (lt >= lo) & (lt <= hi)
        rv = rv & (rt >= lo) & (rt <= hi)

        cx = torch.cat([px, lx, rx], dim=1)               # [T, 3Mp]
        cy = torch.cat([py, ly, ry], dim=1)
        ct = torch.cat([pt, lt, rt], dim=1)
        cv = torch.cat([pv, lv, rv], dim=1)
        slabs = ((px, py, pt, pv), (lx, ly, lt, lv), (rx, ry, rt, rv))
        return cx, cy, ct, cv, slabs

    # ---------------- phase 1: halo exchange + join ----------------
    def _join_slab(self, px, py, pt, pv, ref_ids, cid, kx, ky, kt, kv):
        """One best-match sweep of the candidate points ``[Tc, Mc]`` (the
        ``3Mp`` concat, or one ``Mp`` slab under the ring schedule):
        ``(best_w, best_idx) [T*Mp, Tc]``."""
        params = self.params
        flat = lambda a: a.reshape(-1)
        kx, ky, kt, kv = (a.contiguous() for a in (kx, ky, kt, kv))
        if self.use_kernel:
            from repro_torch.kernels.stjoin.ops import stjoin_best_match
            return stjoin_best_match(
                flat(px), flat(py), flat(pt), ref_ids, flat(pv),
                kx, ky, kt, cid, kv, params.eps_sp, params.eps_t)
        from repro_torch.kernels.stjoin.ref import stjoin_ref
        pair_mask = None
        if self.use_index:
            from repro_torch.index.grid import trajectory_pair_mask
            pmask = trajectory_pair_mask(px, py, pt, pv, kx, ky, kt, kv,
                                         params.eps_sp, params.eps_t)
            pair_mask = pmask.repeat_interleave(self.Mp, dim=0)
        return stjoin_ref(flat(px), flat(py), flat(pt), ref_ids, flat(pv),
                          kx, ky, kt, cid, kv, params.eps_sp, params.eps_t,
                          pair_mask=pair_mask)

    def phase_join(self, px, py, pt, pv, traj_id, cx, cy, ct, cv,
                   slabs=None):
        """``(join, vote, masks)``: ``join`` is this rank's ``[T, Mp,
        Tc]`` column block (``None`` in fused mode), ``vote [T, Mp]``
        summed over ``model``, ``masks`` the TSA2 words ``[T, Mp, W]``
        (``None`` under TSA1).

        Under ``halo_stream="ring"`` the materialize join sweeps one halo
        slab at a time and folds each into a running (best_w, best_idx)
        with strict ``>``: the first occurrence of the maximum, as the
        concatenated sweep; fused mode sweeps the concat and rings its
        word gather instead."""
        params, T, Mp, Tc = self.params, self.T, self.Mp, self.Tc
        c0, sl = self._cand_slice()
        cid = sl(traj_id)
        tsa2 = params.segmentation == "tsa2"

        if self.mode == "fused":
            from repro_torch.kernels.stjoin.ops import \
                stjoin_vote_fused_arrays
            vote_l, words_l = stjoin_vote_fused_arrays(
                px, py, pt, pv, traj_id, sl(cx), sl(cy), sl(ct), sl(cv),
                cid, params.eps_sp, params.eps_t, params.delta_t,
                with_masks=tsa2)
            vote = self.psum_model(vote_l)
            masks = None
            if tsa2:
                allw = self._gather_model(words_l, self.halo_stream)
                masks = allw.permute(1, 2, 0, 3).reshape(
                    T, Mp, self.nM * words_l.shape[-1])
            return None, vote, masks

        ref_ids = traj_id.to(torch.int32)[:, None].expand(T, Mp).reshape(-1)
        if self.halo_stream == "ring" and slabs is not None:
            bw = torch.zeros((T * Mp, Tc), dtype=torch.float32,
                             device=self.dev)
            bidx = torch.full((T * Mp, Tc), -1, dtype=torch.int32,
                              device=self.dev)
            for off, (sx, sy, st, sv) in zip((0, Mp, 2 * Mp), slabs):
                w_s, i_s = self._join_slab(px, py, pt, pv, ref_ids, cid,
                                           sl(sx), sl(sy), sl(st), sl(sv))
                better = w_s > bw
                bidx = torch.where(better, i_s + off, bidx)
                bw = torch.where(better, w_s, bw)
        else:
            bw, bidx = self._join_slab(px, py, pt, pv, ref_ids, cid,
                                       sl(cx), sl(cy), sl(ct), sl(cv))
        join = JoinResult(best_w=bw.reshape(T, Mp, Tc),
                          best_idx=bidx.reshape(T, Mp, Tc))
        if float(params.delta_t) > 0.0:
            join = filter_delta_t(join, pt, params.delta_t)
        vote = self.psum_model(point_voting(join))
        masks = None
        if tsa2:
            allm = self._gather_model(join.best_w > 0.0, self.halo_stream)
            allm = allm.permute(1, 2, 0, 3).reshape(T, Mp, self.nM * Tc)
            masks = pack_bits(allm, rows_per_chunk=PACK_ROWS)
        return join, vote, masks

    # ------------- phases 2+3: regroup + segmentation (Job 1) -----------
    def phase_segment(self, pt, pv, vote, masks):
        """``(table, labels)``: the replicated global subtrajectory table
        and this partition's ``sub_local`` labels ``[T, Mp]``."""
        params, nP, Tl, Mp, Mtot = (self.params, self.nP, self.Tl,
                                    self.Mp, self.Mtot)
        maxS, T = self.maxS, self.T

        def regroup(a):      # [T, Mp, ...] -> [Tl, nP * Mp, ...]
            a = a.reshape(nP, Tl, *a.shape[1:])
            a = self.comm.all_to_all(a, self.part_axis, split_axis=0,
                                     concat_axis=1)
            return a.reshape(Tl, nP * Mp, *a.shape[3:])

        g_vote = regroup(vote)
        g_t = regroup(pt)
        g_v = regroup(pv)
        g_masks = regroup(masks) if params.segmentation == "tsa2" else None

        # compact: valid points first (windows need a contiguous prefix)
        order = torch.argsort(torch.where(g_v, 0, 1).to(torch.int8), dim=1,
                              stable=True)
        inv_order = torch.argsort(order, dim=1)
        takev = lambda a: torch.gather(a, 1, order)
        c_vote, c_t, c_v = takev(g_vote), takev(g_t), takev(g_v)

        if params.segmentation == "tsa1":
            nvote = normalized_voting(c_vote, c_v)
            seg = seg_mod.tsa1(nvote, c_v, params.w, params.tau, maxS)
        else:
            c_masks = torch.gather(
                g_masks, 1, order[..., None].expand_as(g_masks))
            seg = seg_mod.tsa2(c_masks, c_v, params.w, params.tau, maxS,
                               use_kernel=self.seg_use_kernel)

        table_l = build_subtraj_table_arrays(c_t, c_v, seg.sub_local, c_vote,
                                             maxS)       # S_l = Tl * maxS
        g = self.comm.all_gather(_pack_table(table_l), self.part_axis)
        g = g.permute(1, 0, 2).reshape(5, self.S)
        table = SubtrajTable(
            t_start=g[0].clone(), t_end=g[1].clone(), voting=g[2].clone(),
            card=g[3].clone().view(torch.int32), valid=g[4] > 0.5,
            traj_row=torch.arange(T, dtype=torch.int32,
                                  device=self.dev).repeat_interleave(maxS))

        # labels back to the partition layout
        sub_padded = torch.gather(seg.sub_local, 1, inv_order)
        sub_padded = sub_padded.reshape(Tl, nP, Mp)
        labels = self.comm.all_to_all(sub_padded, self.part_axis,
                                      split_axis=1, concat_axis=0)
        return table, labels.reshape(T, Mp)

    def gids(self, labels, pv, cv):
        """Global subtrajectory slots of the own points and of the label
        halo ``[T, 3Mp]`` (``S`` where unsegmented)."""
        T, maxS, S = self.T, self.maxS, self.S
        rows = torch.arange(T, dtype=torch.int32, device=self.dev)[:, None]
        lab = torch.where(labels >= 0, labels, -1)
        gid_own = torch.where((labels >= 0) & pv, rows * maxS + labels, S)
        ll, rl = self.halo(lab)
        lab_cat = torch.cat([lab, ll, rl], dim=1)
        gid_cat = torch.where((lab_cat >= 0) & cv, rows * maxS + lab_cat, S)
        return gid_own.to(torch.int32), gid_cat.to(torch.int32)

    # ---------------- phase 4: similarity (SP relation) -----------------
    def phase_similarity(self, px, py, pt, pv, traj_id, cx, cy, ct, cv,
                         join, gid_own, gid_cat, table):
        """``(sim, topk, moments, active)``; exactly one of ``sim`` /
        ``topk`` is not None (``moments`` rides in the ``TopKSim`` in
        top-K mode and is None then)."""
        params, T, S = self.params, self.T, self.S
        maxS, nM = self.maxS, self.nM
        c0, sl = self._cand_slice()
        cid = sl(traj_id)
        S_loc = self.Tc * maxS
        c0s = c0 * maxS
        # this rank's candidates' slots, local to its column block
        gid_cand = sl(gid_cat)
        gidc_l = torch.where(gid_cand < S, gid_cand - c0s, S_loc).to(
            torch.int32)

        # subtrajectories active in THIS partition
        active = torch.zeros((S + 1,), dtype=torch.bool, device=self.dev)
        active[gid_own.reshape(-1).long()] = True
        active = active[:S]
        part_valid = table.valid & active

        def rank_raw_block():
            """This rank's ``[S, S_loc]`` candidate-column block of
            ``raw``: K4 (fused) or the cube's ordered scatter."""
            if self.mode == "fused":
                from repro_torch.kernels.stjoin.ops import \
                    stjoin_sim_fused_arrays
                return stjoin_sim_fused_arrays(
                    px, py, pt, pv, traj_id, gid_own, sl(cx), sl(cy),
                    sl(ct), sl(cv), cid, gidc_l, S, S_loc, params.eps_sp,
                    params.eps_t, params.delta_t)
            return scatter_raw(join.best_w, join.best_idx, gid_own, gidc_l,
                               S, S_loc)

        def moments_psum(sim_block):
            """Row moments of this rank's final column block, summed over
            ``model``: both representations feed the same block, so dense
            and top-K resolve the same alpha."""
            cnt, rsum, rsumsq = sim_row_moments(
                sim_block, part_valid, part_valid[c0s:c0s + S_loc],
                use_kernel=self.cluster_use_kernel)
            return (self.psum_model(cnt), self.psum_model(rsum),
                    self.psum_model(rsumsq))

        if self.sim_mode == "topk":
            K = min(self.sim_topk, S)
            raw_blk = rank_raw_block()                     # [S, S_loc]
            a = raw_blk.reshape(nM, S_loc, S_loc)
            if self.sim_exchange == "ring":
                # shifted-ppermute transpose exchange: at step s rank r
                # ships the sub-block for rank r + s and max-folds the one
                # that landed into its band (each band once, as the
                # barrier exchange)
                mrank = self.comm.axis_index(self.model_axis)
                sym_blk = torch.empty_like(raw_blk)

                def fold(src_rank, chunk):
                    k0 = src_rank * S_loc
                    band = raw_blk[k0:k0 + S_loc]
                    sym_blk[k0:k0 + S_loc] = torch.maximum(band, chunk.T)

                fold(mrank, a[mrank])
                for s in range(1, nM):
                    perm = [(i, (i + s) % nM) for i in range(nM)]
                    chunk = self.comm.ppermute(
                        a[(mrank + s) % nM].contiguous(), self.model_axis,
                        perm)
                    fold((mrank - s) % nM, chunk)
            else:
                # transpose-partner exchange: rank r sends raw[cols_k,
                # cols_r] to rank k and assembles raw[cols_r, :]
                tpart = self.comm.all_to_all(a, self.model_axis,
                                             split_axis=0, concat_axis=1)
                tpart = tpart.reshape(S_loc, S)
                sym_blk = torch.maximum(raw_blk, tpart.T, out=raw_blk)
                del tpart
            del raw_blk, a
            simb = finalize_sim_cols(sym_blk, c0s, table, active)
            del sym_blk
            cnt, rsum, rsumsq = moments_psum(simb)
            kk = min(K + 1, S_loc)
            vals, idx_l = _top_k(simb, kk)
            del simb
            lids = idx_l + c0s
            if self.sim_exchange == "ring":
                # the per-rank lists around the forwarding ring, each
                # folded into the standing top-(K+1) by the canonical
                # pairwise merge (order-invariant: the barrier's bits)
                perm = [(i, (i + 1) % nM) for i in range(nM)]
                run_i, run_v = lids, vals
                buf_i, buf_v = lids, vals
                for s in range(1, nM):
                    buf_v = self.comm.ppermute(buf_v, self.model_axis, perm)
                    buf_i = self.comm.ppermute(buf_i, self.model_axis, perm)
                    run_i, run_v = merge_topk_lists(
                        run_i, run_v, buf_i, buf_v, min(K + 1, (s + 1) * kk))
            else:
                g_vals = self.comm.all_gather(vals, self.model_axis)
                g_ids = self.comm.all_gather(lids, self.model_axis)
                run_v = g_vals.permute(1, 0, 2).reshape(S, nM * kk)
                run_i = g_ids.permute(1, 0, 2).reshape(S, nM * kk)
                del g_vals, g_ids
            # the k-way merge, in row chunks (its sorts' temporaries are
            # several [rows, nM * (K + 1)] copies); the list kernels take
            # contiguous operands
            ids = torch.empty((S, K), dtype=torch.int32, device=self.dev)
            sims = torch.empty((S, K), dtype=torch.float32, device=self.dev)
            spill = torch.empty((S,), dtype=torch.float32, device=self.dev)
            for r0 in range(0, S, ROW_CHUNK):
                r = slice(r0, r0 + ROW_CHUNK)
                ids[r], sims[r], spill[r] = merge_topk_blocks(
                    run_i[r], run_v[r], K)
            topk = TopKSim(ids=ids, sims=sims, spill=spill, degree=cnt,
                           row_sum=rsum, row_sumsq=rsumsq)
            return None, topk, None, active

        # ``psum`` and ``allgather`` alike: the column blocks side by side
        # (the reference's psum of zero-padded blocks is this
        # concatenation: every cell is non-zero on one rank at most)
        blk = rank_raw_block()
        if self.sim_dtype == "bf16":
            blk = blk.to(torch.bfloat16)
        gathered = self._gather_model(blk, self.sim_exchange)
        del blk
        raw = gathered.permute(1, 0, 2).reshape(S, S)
        del gathered
        raw = raw.to(torch.float32)

        # Eq. 2 normalization, shared with the single-device path, then
        # the partition's active rows and columns
        sim = finalize_sim(raw, table)
        del raw
        for r0 in range(0, S, ROW_CHUNK):
            r = slice(r0, r0 + ROW_CHUNK)
            sim[r].masked_fill_(~(active[r, None] & active[None, :]), 0.0)
        moments = moments_psum(sim[:, c0s:c0s + S_loc])
        return sim, None, moments, active

    # ------------- phase 5: per-partition clustering --------------------
    def phase_cluster(self, sim, topk, moments, table, active):
        """``(res_l, diag)`` for THIS partition's shard."""
        part_table = dataclasses.replace(table, valid=table.valid & active)
        if topk is not None:
            res_l = cluster(topk, part_table, self.params,
                            engine=self.cluster_engine,
                            use_kernel=self.cluster_use_kernel,
                            tiles=self.plan.cluster_tiles)
            overflow = topk_overflow(topk, res_l.alpha_used)
            meansim = topk.row_sum.sum() / topk.degree.sum().clamp_min(1)
        else:
            res_l = cluster(sim, part_table, self.params,
                            engine=self.cluster_engine,
                            use_kernel=self.cluster_use_kernel,
                            moments=moments, tiles=self.plan.cluster_tiles)
            overflow = torch.zeros((), dtype=torch.int32, device=self.dev)
            # sim >= 0, so the positive entries sum as the whole matrix
            meansim = sim.sum() / (sim > 0).sum().clamp_min(1)
        diag = torch.stack([meansim.to(torch.float32), res_l.alpha_used,
                            res_l.k_used, overflow.to(torch.float32)])
        return res_l, diag

    # ------------- phase 6: cross-partition refinement ------------------
    def phase_refine(self, res_l, active):
        """One packed ``[4, S]`` gather over ``part`` (member ids as
        bitcast f32 lanes, booleans as 0 / 1) and Algorithm 5."""
        packed = torch.stack([res_l.member_of.view(torch.float32),
                              res_l.member_sim,
                              res_l.is_rep.to(torch.float32),
                              active.to(torch.float32)])
        g = self.comm.all_gather(packed, self.part_axis)       # [nP, 4, S]
        return refine_states(
            g[:, 0].contiguous().view(torch.int32), g[:, 1].contiguous(),
            g[:, 2] > 0.5, g[:, 3] > 0.5,
            self.comm.pmean(res_l.alpha_used, self.part_axis),
            self.comm.pmean(res_l.k_used, self.part_axis))

    def gather_part(self, x):
        """``[P, ...]``: ``x`` of every partition, on every rank."""
        return self.comm.all_gather(x.contiguous(), self.part_axis)

    # ------------- the monolith: phases 1-3, then 4-6 ------------------
    def run_front(self, x, y, t, valid, traj_id, ranges):
        """Phases 1-3 on this rank's partition of the ``[P, ...]``
        arrays: the state the K-reading phases start from."""
        with self.span("halo"):
            px, py, pt, pv = (self.local(a) for a in (x, y, t, valid))
            traj_id = traj_id.to(self.dev)
            cx, cy, ct, cv, slabs = self.halo_points(px, py, pt, pv,
                                                     self.local(ranges))
        with self.span("join"):
            join, vote, masks = self.phase_join(px, py, pt, pv, traj_id,
                                                cx, cy, ct, cv, slabs)
        with self.span("segment"):
            table, labels = self.phase_segment(pt, pv, vote, masks)
            del masks
            gid_own, gid_cat = self.gids(labels, pv, cv)
        return (px, py, pt, pv, traj_id, cx, cy, ct, cv, join, vote, table,
                gid_own, gid_cat)

    def run_back(self, front):
        """Phases 4-6 (they read K): ``(result, table, vote [P, T, Mp],
        active [P, S], diag [P, 4])`` on every rank."""
        (px, py, pt, pv, traj_id, cx, cy, ct, cv, join, vote, table,
         gid_own, gid_cat) = front
        with self.span("similarity"):
            sim, topk, moments, active = self.phase_similarity(
                px, py, pt, pv, traj_id, cx, cy, ct, cv, join, gid_own,
                gid_cat, table)
        with self.span("cluster"):
            res_l, diag = self.phase_cluster(sim, topk, moments, table,
                                             active)
            del sim, topk
        with self.span("refine"):
            final = self.phase_refine(res_l, active)
            return (final, table, self.gather_part(vote),
                    self.gather_part(active), self.gather_part(diag))


def _comm(mesh: Mesh) -> MeshComm:
    comm = mesh_mod.comm_for(mesh)
    if comm is None:
        raise RuntimeError("no process group is up: run the program "
                           "through run_dsc_distributed or "
                           "repro_torch.distributed.mesh.spawn")
    return comm


def build_dsc_program(parts: PartitionedBatch, params: DSCParams,
                      mesh: Mesh, *, part_axis: str = "part",
                      model_axis: str = "model",
                      plan: EnginePlan | None = None, stage_times=None,
                      **kw):
    """The per-rank program for ``parts``' shapes: ``body(x, y, t, valid,
    traj_id, ranges)`` over the ``[P, ...]`` arrays (each rank reads its
    partition) returns ``(result, table, vote [P, T, Mp], active [P, S],
    diag [P, 4])`` on every rank.  Must run on a rank of ``mesh``.
    ``body.front`` (phases 1-3, same arguments) and ``body.back`` (phases
    4-6, on ``front``'s state) are its two halves, ``body.builder`` the
    ``_DSCProgramBuilder`` they run on (its ``sim_topk`` is the K that
    ``back`` reads).

    ``plan=`` carries every per-stage choice; the keywords are the
    reference's deprecated aliases (``use_kernel``, ``mode``,
    ``sim_strategy``, ``sim_dtype``, ``halo_stream``, ...), which
    materialize a plan.  ``mode="fused"`` runs K2 and K4 and builds no
    join cube; the dense relation gathers the ranks' ``[S, S_loc]``
    column blocks under either ``sim_strategy``; ``sim_dtype="bf16"``
    moves them as bfloat16; ``sim_mode="topk"`` keeps the relation sparse
    (transpose exchange, per-rank top-(K+1), k-way merge); ``halo_stream``
    / ``sim_exchange = "ring"`` swap the gathers for ``ppermute`` rings
    with the same bits.  ``stage_times`` (a dict) is filled with this
    rank's ms per phase (``halo``, ``join``, ``segment``, ``similarity``,
    ``cluster``, ``refine``; CUDA events on the card), summed over the
    calls."""
    plan = resolve_plan(plan, **kw)
    comm = _comm(mesh)
    timer = None
    if stage_times is not None:
        from repro_torch.core.dsc import StageTimer
        timer = StageTimer(comm.device)
    b = _DSCProgramBuilder(parts, params, mesh, part_axis, model_axis, plan,
                           comm, timer)

    def back(front):
        out = b.run_back(front)
        if timer is not None:
            stage_times.update(timer.times)
        return out

    def body(x, y, t, valid, traj_id, ranges):
        return back(b.run_front(x, y, t, valid, traj_id, ranges))

    body.front, body.back, body.builder = b.run_front, back, b
    return body


def _rank_run(parts, params, mesh, part_axis, model_axis, on_overflow,
              plan, stage_times):
    """This rank's ``run_dsc_distributed``: ``build_dsc_program``'s body,
    its front once.  The widen loop reruns the back half (similarity,
    cluster, refine: the phases that read K) with K doubled: the join and
    segmentation do not read it, so each retry gives what the reference's
    whole-program re-dispatch gives (as ``run_dsc``'s loop does on one
    device)."""
    body = build_dsc_program(parts, params, mesh, part_axis=part_axis,
                             model_axis=model_axis, plan=plan,
                             stage_times=stage_times)
    b = body.builder
    front = body.front(parts.x, parts.y, parts.t, parts.valid,
                       parts.traj_id, parts.ranges)
    while True:
        final, table, vote, active, diag = body.back(front)
        out = DistributedDSCOutput(result=final, table=table, vote=vote,
                                   active=active, sim_diag=diag)
        if plan.sim_mode != "topk":
            return out
        overflow = int(diag[:, 3].sum())
        if overflow == 0 or on_overflow == "degrade":
            return out
        k = b.sim_topk
        if on_overflow == "raise":
            raise RuntimeError(
                f"sim_topk={k} truncated potential "
                f"alpha-edges on {overflow} rows across partitions "
                "(spill >= alpha): labels would not be exact.  Rerun "
                "with a larger sim_topk.")
        if k >= b.S:            # unreachable: K == S cannot spill
            raise AssertionError("overflow with K == S")
        b.sim_topk = min(2 * k, b.S)


def run_dsc_distributed(parts: PartitionedBatch, params: DSCParams,
                        mesh: Mesh, *, part_axis: str = "part",
                        model_axis: str = "model", on_overflow: str = "raise",
                        plan: EnginePlan | None = None, stage_times=None,
                        **kw) -> DistributedDSCOutput:
    """Run the distributed pipeline on ``mesh``.

    On a rank of a process group of the mesh's size (``mesh.spawn``, or
    ``torch.distributed`` started by the caller) this runs the rank's
    program and returns the output every rank assembles: ``result`` and
    ``table`` replicated, ``vote``, ``active`` and ``sim_diag`` gathered
    over ``part``, on the rank's device.  Anywhere else it spawns the
    ``P * M`` ranks (``mesh.spawn``) and returns rank 0's output on the
    mesh's device.

    ``plan=`` takes one :class:`EnginePlan`; the other keywords are the
    deprecated aliases (see ``build_dsc_program``).  Under
    ``sim_mode="topk"`` ``on_overflow`` names the policy when a
    partition's certificate fails: ``"raise"`` (the default) raises
    ``RuntimeError``, ``"widen"`` reruns the phases that read K
    (similarity, cluster, refine) with K doubled until it holds (the same
    outputs as the reference's rerun of the whole program),
    ``"degrade"`` returns the truncated result with the violation counts
    in ``sim_diag[:, 3]``.  ``stage_times`` (a dict, on a rank) is filled
    with the rank's ms per phase, summed over the widen reruns.
    """
    if on_overflow not in _ON_OVERFLOW:
        raise ValueError(f"on_overflow={on_overflow!r}: expected "
                         "'raise', 'widen', or 'degrade'")
    plan = resolve_plan(plan, **kw)
    args = (parts, params, mesh, part_axis, model_axis, on_overflow, plan,
            stage_times)
    if mesh_mod.comm_for(mesh) is not None:
        return _rank_run(*args)
    out = mesh_mod.spawn(_rank_run, mesh, *args)[0]
    return mesh_mod.to_device(out, torch.device(
        "cpu" if mesh.device == "cpu" else "cuda"))


def refine_stage(member_of, member_sim, is_rep, active, alpha, k):
    """Stage 5 of the staged pipeline: Algorithm 5 on the stacked
    per-partition states.  ``alpha`` / ``k`` are the per-partition ``[P]``
    vectors; their mean is summed in partition order, as the monolith's
    ``pmean`` sums, so a chain gives the monolith's bits."""
    def mean(v):
        acc = v[0]
        for i in range(1, v.shape[0]):
            acc = acc + v[i]
        return acc / v.shape[0]

    return refine_states(member_of, member_sim, is_rep, active, mean(alpha),
                         mean(k))


def build_dsc_stage_programs(parts: PartitionedBatch, params: DSCParams,
                             mesh: Mesh, *, part_axis: str = "part",
                             model_axis: str = "model",
                             plan: EnginePlan | None = None,
                             **kw) -> dict:
    """One function per checkpointable stage boundary, over the phase
    methods the monolith runs, so running them in sequence replays the
    monolith's computation bit for bit.  Every function runs on every rank
    of ``mesh`` together; inputs and outputs are the global ``[P, ...]``
    arrays (each rank reads its partition; outputs are gathered over
    ``part`` onto every rank):

    ``join``        ``(x..ranges) -> (vote, masks[, best_w, best_idx])``;
                    materialize mode gathers the cube over ``model`` to
                    its full ``[P, T, Mp, T]`` span (``masks`` is zeros
                    ``[P, T, Mp, 1]`` under TSA1);
    ``segment``     ``(t, valid, vote, masks) -> (table, labels)``;
    ``similarity``  points + labels + table (+ cube) -> the top-K fields
                    ``(ids, sims, spill, degree, row_sum, row_sumsq,
                    active)`` or ``(sim, cnt, rsum, rsumsq, active)``;
    ``cluster``     ``(table, active, *state) -> (member_of, member_sim,
                    is_rep, is_outlier, alpha [P], k [P], diag [P, 4])``;
    ``refine``      :func:`refine_stage` (needs no mesh).
    """
    plan = resolve_plan(plan, **kw)
    comm = _comm(mesh)
    b = _DSCProgramBuilder(parts, params, mesh, part_axis, model_axis, plan,
                           comm)
    gp = b.gather_part

    def points(x, y, t, valid, traj_id, ranges):
        px, py, pt, pv = (b.local(a) for a in (x, y, t, valid))
        traj_id = traj_id.to(b.dev)
        return (px, py, pt, pv, traj_id,
                *b.halo_points(px, py, pt, pv, b.local(ranges)))

    def join_fn(x, y, t, valid, traj_id, ranges):
        px, py, pt, pv, tid, cx, cy, ct, cv, slabs = points(
            x, y, t, valid, traj_id, ranges)
        join, vote, masks = b.phase_join(px, py, pt, pv, tid, cx, cy, ct,
                                         cv, slabs)
        if masks is None:
            masks = torch.zeros((b.T, b.Mp, 1), dtype=torch.int32,
                                device=b.dev)
        if join is None:
            return gp(vote), gp(masks)
        gw = b._gather_model(join.best_w, plan.halo_stream)
        gi = b._gather_model(join.best_idx, plan.halo_stream)
        bw = gw.permute(1, 2, 0, 3).reshape(b.T, b.Mp, b.T)
        bidx = gi.permute(1, 2, 0, 3).reshape(b.T, b.Mp, b.T)
        return gp(vote), gp(masks), gp(bw), gp(bidx)

    def segment_fn(t, valid, vote, masks):
        m = b.local(masks) if params.segmentation == "tsa2" else None
        table, labels = b.phase_segment(b.local(t), b.local(valid),
                                        b.local(vote), m)
        return table, gp(labels)

    def similarity_fn(x, y, t, valid, traj_id, ranges, labels, table,
                      *cube):
        px, py, pt, pv, tid, cx, cy, ct, cv, _ = points(
            x, y, t, valid, traj_id, ranges)
        join = None
        if cube:
            c0, _ = b._cand_slice()
            join = JoinResult(
                best_w=b.local(cube[0])[:, :, c0:c0 + b.Tc].contiguous(),
                best_idx=b.local(cube[1])[:, :, c0:c0 + b.Tc].contiguous())
        gid_own, gid_cat = b.gids(b.local(labels), pv, cv)
        sim, topk, moments, active = b.phase_similarity(
            px, py, pt, pv, tid, cx, cy, ct, cv, join, gid_own, gid_cat,
            _table_to(table, b.dev))
        if topk is not None:
            return (gp(topk.ids), gp(topk.sims), gp(topk.spill),
                    gp(topk.degree), gp(topk.row_sum), gp(topk.row_sumsq),
                    gp(active))
        cnt, rsum, rsumsq = moments
        return gp(sim), gp(cnt), gp(rsum), gp(rsumsq), gp(active)

    def cluster_fn(table, active, *state):
        table = _table_to(table, b.dev)
        st = [b.local(s) for s in state]
        if plan.sim_mode == "topk":
            topk = TopKSim(*st)
            res_l, diag = b.phase_cluster(None, topk, None, table,
                                          b.local(active))
        else:
            res_l, diag = b.phase_cluster(st[0], None, tuple(st[1:]), table,
                                          b.local(active))
        return (gp(res_l.member_of), gp(res_l.member_sim), gp(res_l.is_rep),
                gp(res_l.is_outlier), gp(res_l.alpha_used),
                gp(res_l.k_used), gp(diag))

    return {"join": join_fn, "segment": segment_fn,
            "similarity": similarity_fn, "cluster": cluster_fn,
            "refine": refine_stage}


def _table_to(table: SubtrajTable, dev) -> SubtrajTable:
    return SubtrajTable(*(getattr(table, f.name).to(dev)
                          for f in dataclasses.fields(table)))
