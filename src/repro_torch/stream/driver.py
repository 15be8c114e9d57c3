"""Windowed incremental DSC: the long-running streaming service core
(counterpart of ``repro.stream.driver``).

The :class:`StreamDriver` keeps one *active window* of the stream — a
fixed-capacity ``[T, M]`` trajectory store over event times in
``[watermark - horizon, +inf)``, held on the host where records are
inserted one by one — plus the standing derived state of the whole DSC
pipeline over that window, held on the run's device (the card unless the
caller asks for the CPU):

* the join **cube** ``cube_w / cube_idx [T, M, T]`` (DTJ output with the
  window itself as candidate set; 17.2 GB at T = 4096, M = 128),
* per-point voting and segmentation (``sub_local``) and the ST relation
  over ``S = T * max_subs`` slots,
* **standing neighbor lists** ``[S, K+1]`` — the canonical top-``K+1``
  of the window's similarity rows (the +1 column is the spill that feeds
  the exactness certificate),
* cluster labels from warm-started round-parallel Algorithm 4.

Incrementality contract (DESIGN.md §13.4), the reference's step by step:
every window advance computes exactly what a from-scratch batch run over
the current window contents would (``run_dsc(window_batch(), ...,
sim_mode="topk", on_overflow="degrade")``, bit for bit):

1. admitted records are inserted time-sorted into their object's row;
   the touched rows are **dirty**;
2. eviction (event time < ``watermark - horizon``) left-packs rows and
   extends the dirty set;
3. only dirty rows get fresh bounding boxes and a **delta join**: dirty
   rows against the whole window and the whole window against the dirty
   rows.  Each ``(r, m, c)`` cell is a function of rows ``r`` and ``c``
   alone, so the clean x clean block stays exact.  On the card the delta
   join is K1 (``kernels.stjoin.ops.best_match_join_kernel``, the
   materialize kernel plan's join) over chunks of ``JOIN_ELEMENTS``
   output cells; on the CPU the plain join under the rows' bbox pair mask
   (``index.grid.exact_pair_mask``, which only drops pairs that cannot
   match), as the reference runs it and as the plain plan's batch join
   gives it;
4. voting / segmentation / ST rebuild from the cube through the bodies
   ``run_dsc`` runs (``core.dsc._vote_from_join_body``,
   ``_segment_body``), so the vote sums in the batch path's order; rows
   whose segmentation changed join the dirty set for similarity;
5. a **fresh block** recomputes the dirty slots' similarity rows and
   columns from the cube (``core.similarity.scatter_raw``: one ordered
   scatter per point position, each cell adding in the batch path's
   ``(m, c)`` order), in chunks of ``FRESH_ELEMENTS``; standing lists
   merge it: dirty rows are replaced outright, clean rows purge
   dirty/invalid neighbors and fold the fresh *column* candidates back in
   via the canonical ``sort_topk_lists`` merge;
6. clean rows whose list may have lost mass they cannot prove they never
   needed (**stale**) are recomputed outright in a second fresh-block
   pass within the same advance (pass 2 purges nothing: two passes
   suffice);
7. clustering warm-starts: slots whose visit rank, potential flag and
   neighbor list all survived unchanged — the visit-order prefix
   ``[0, r*)`` — are seeded as resolved with their previous verdicts
   (``cluster_rounds_topk(seed_resolved=, seed_is_rep=)``: K8 and K9 on
   the card, the plain engine on the CPU); the absolute thresholds of :class:`StreamConfig` keep alpha
   and k from drifting with the window;
8. every ``snapshot_every`` advances the full state snapshots through
   :class:`~repro_torch.checkpoint.CheckpointManager` in the reference's
   tree paths, dtypes, schema and ``StreamConfig.fingerprint()``, so a
   killed service resumes bit-identically — also from a snapshot the
   reference wrote, and the other way round.

Top-K ties follow ``lax.top_k`` (equal values by ascending column):
stable descending sorts.  The fresh block's candidate width ``kc = min(kk,
Sd)`` uses the reference's power-of-two row bucket for ``Sd``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, checkpoint_meta
from repro_torch.core import dsc as dsc_mod
from repro_torch.core.clustering import cluster_rounds_topk, visit_order
from repro_torch.core.geometry import best_match_join, filter_delta_t
from repro_torch.core.plan import EnginePlan
from repro_torch.core.similarity import (scatter_raw, slot_ids,
                                         sort_topk_lists, topk_overflow)
from repro_torch.core.types import (DSCParams, JoinResult, SubtrajTable,
                                    TopKSim, TrajectoryBatch)
from repro_torch.index.grid import TileBoxes, exact_pair_mask
from repro_torch.kernels import resolve_device
from repro_torch.stream.ingest import Ingestor, Records
from repro_torch.stream.window import BackpressureOverflow, WindowManager

# bump when the snapshot layout changes; resume refuses mismatches
STREAM_SNAPSHOT_SCHEMA = 1
# output cells ([rows, M, T] or [T, M, rows]) of one delta-join chunk
JOIN_ELEMENTS = 1 << 27
# [slots, S] cells of one fresh-block chunk (each of fwd, rev, sim; its
# gathers of the cube are bounded by JOIN_ELEMENTS too)
FRESH_ELEMENTS = 1 << 27


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Everything the streaming service needs, in one frozen record (the
    reference's fields and defaults: its ``fingerprint`` is the port's).

    Thresholds are **absolute** (``alpha_abs``/``k_abs`` >= 0 required):
    sigma-relative thresholds would drift with the window's similarity
    distribution, invalidating both the warm-start seeding and the
    advance-to-advance comparability of labels.
    """

    t_cap: int                    # window row capacity (objects)
    m_cap: int                    # per-row point capacity
    eps_sp: float
    eps_t: float
    alpha_abs: float
    k_abs: float
    allowed_lateness: float
    horizon: float
    max_subs: int = 4
    k: int = 8                    # neighbor-list width K (lists keep K+1)
    delta_t: float = 0.0
    w: int = 4
    tau: float = 0.4
    segmentation: str = "tsa1"
    queue_cap: int = 4096
    backpressure: str = "shed_oldest"   # "shed_oldest" | "block"
    on_dirty: str = "repair"            # "repair" | "drop" | "fail"
    max_speed: Optional[float] = None
    stall_advances: int = 0
    snapshot_every: int = 0             # 0 disables periodic snapshots
    warm_start: bool = True

    def validate(self) -> "StreamConfig":
        for name in ("t_cap", "m_cap", "max_subs", "k"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if self.alpha_abs < 0 or self.k_abs < 0:
            raise ValueError(
                "streaming requires absolute thresholds: alpha_abs and "
                "k_abs must be >= 0 (sigma-relative thresholds drift with "
                "the window and break warm-start validity)")
        if self.horizon < self.allowed_lateness:
            raise ValueError(
                f"horizon ({self.horizon}) must cover allowed_lateness "
                f"({self.allowed_lateness}): a tolerably-late record must "
                "still land inside the active window")
        if self.segmentation not in ("tsa1", "tsa2"):
            raise ValueError(f"segmentation={self.segmentation!r}")
        if self.backpressure not in ("shed_oldest", "block"):
            raise ValueError(f"backpressure={self.backpressure!r}")
        if self.on_dirty not in ("repair", "drop", "fail"):
            raise ValueError(f"on_dirty={self.on_dirty!r}")
        return self

    @property
    def params(self) -> DSCParams:
        return DSCParams(
            eps_sp=self.eps_sp, eps_t=self.eps_t, delta_t=self.delta_t,
            w=self.w, tau=self.tau, alpha_abs=self.alpha_abs,
            k_abs=self.k_abs, max_subtrajs_per_traj=self.max_subs,
            segmentation=self.segmentation)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "StreamConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown StreamConfig fields "
                             f"{sorted(unknown)}")
        return cls(**d).validate()

    def fingerprint(self) -> str:
        """Stable digest of the config; snapshots embed it and resume
        refuses state written under a different configuration."""
        return hashlib.sha1(
            json.dumps(self.to_dict(), sort_keys=True).encode()).hexdigest()


def _pow2_bucket(n: int, cap: int) -> int:
    """Next power of two >= n, clamped to cap (the reference's padded
    dirty-row count; it sets the fresh block's candidate width)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _chunks(rows: torch.Tensor, per: int):
    for i in range(0, rows.shape[0], per):
        yield rows[i:i + per]


def _desc(x: torch.Tensor, n: int):
    """``(values, indices)`` of the ``n`` largest entries of each row,
    equal values by ascending column (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :n], idx[:, :n]


class StreamDriver:
    """The incremental windowed-DSC service state machine.  ``device``
    (``None`` = the card) holds the standing state and runs the
    pipeline."""

    def __init__(self, config: StreamConfig, *,
                 checkpoint_dir=None, telemetry=None, injector=None,
                 keep_n: int = 3, device=None):
        self.config = config.validate()
        self.device = resolve_device(device)
        c = self.config
        T, M, mS = c.t_cap, c.m_cap, c.max_subs
        S = T * mS
        self.S = S
        self.kk = min(c.k + 1, S)        # standing list width (K + spill)
        self.K = min(c.k, self.kk)

        self.telemetry = telemetry
        self.injector = injector
        # a weak reference back: a bound method would make the driver a
        # reference cycle, and its card state (the cube) would outlive the
        # last reference to the service until a garbage collection
        me = weakref.ref(self)
        self.ingest = Ingestor(on_dirty=c.on_dirty, max_speed=c.max_speed,
                               known_t_fn=lambda obj: me()._known_t(obj))
        self.window = WindowManager(
            allowed_lateness=c.allowed_lateness, horizon=c.horizon,
            queue_cap=c.queue_cap, policy=c.backpressure,
            stall_advances=c.stall_advances)
        self.manager = (CheckpointManager(checkpoint_dir, keep_n=keep_n)
                        if checkpoint_dir is not None else None)

        dev = self.device
        i32, f32 = torch.int32, torch.float32
        # ---- window store (host) ------------------------------------------
        self.obj_of_row = np.full((T,), -1, np.int64)
        self._row_of: dict[int, int] = {}
        self.xs = np.zeros((T, M), np.float32)
        self.ys = np.zeros((T, M), np.float32)
        self.ts = np.zeros((T, M), np.float32)
        self.valid = np.zeros((T, M), bool)
        self.bx_min = np.full((T,), np.inf, np.float32)
        self.bx_max = np.full((T,), -np.inf, np.float32)
        self.by_min = np.full((T,), np.inf, np.float32)
        self.by_max = np.full((T,), -np.inf, np.float32)
        self.bt_min = np.full((T,), np.inf, np.float32)
        self.bt_max = np.full((T,), -np.inf, np.float32)
        self.b_nonempty = np.zeros((T,), bool)
        # ---- standing derived state (device) ------------------------------
        self.cube_w = torch.zeros((T, M, T), dtype=f32, device=dev)
        self.cube_idx = torch.full((T, M, T), -1, dtype=i32, device=dev)
        self.vote = torch.zeros((T, M), dtype=f32, device=dev)
        self.sub_local = torch.full((T, M), -1, dtype=i32, device=dev)
        self.standing_ids = torch.full((S, self.kk), -1, dtype=i32,
                                       device=dev)
        self.standing_sims = torch.zeros((S, self.kk), dtype=f32,
                                         device=dev)
        self.t_start = torch.zeros((S,), dtype=f32, device=dev)
        self.t_end = torch.zeros((S,), dtype=f32, device=dev)
        self.voting = torch.zeros((S,), dtype=f32, device=dev)
        self.card = torch.zeros((S,), dtype=i32, device=dev)
        self.tvalid = torch.zeros((S,), dtype=torch.bool, device=dev)
        self.traj_row = torch.arange(T, dtype=i32,
                                     device=dev).repeat_interleave(mS)
        self.member_of = torch.full((S,), -1, dtype=i32, device=dev)
        self.member_sim = torch.zeros((S,), dtype=f32, device=dev)
        self.is_rep = torch.zeros((S,), dtype=torch.bool, device=dev)
        self.is_outlier = torch.zeros((S,), dtype=torch.bool, device=dev)
        self.alpha = float(c.alpha_abs)
        self.k_used = float(c.k_abs)
        self.prev_rank = torch.zeros((S,), dtype=i32, device=dev)
        self.prev_potential = torch.zeros((S,), dtype=torch.bool,
                                          device=dev)
        self.prev_is_rep = torch.zeros((S,), dtype=torch.bool, device=dev)
        self.has_prev = False
        # ---- counters ------------------------------------------------------
        self.advance_count = 0
        self.cursor = 0                  # next submission-batch index
        self.evicted_points = 0
        self.shed_capacity = 0           # records shed for lack of a row
        self.row_overflow = 0            # oldest points dropped from a row
        self.overflow_events = 0         # advances with topk overflow > 0
        self.inserted_total = 0
        self.last_rounds = 0
        self.warm_prefix = 0

    # ------------------------------------------------------------- plumbing
    def _known_t(self, obj: int) -> np.ndarray:
        r = self._row_of.get(int(obj))
        if r is None:
            return np.empty((0,), np.float32)
        return self.ts[r][self.valid[r]]

    def _emit(self, event: str, **fields):
        if self.telemetry is not None:
            self.telemetry.emit(event, **fields)

    # ------------------------------------------------------------------ api
    def submit(self, recs: Records) -> int:
        """Validate and stage one submission batch; returns its absolute
        index (the fault plan's and the resume cursor's key)."""
        idx = self.cursor
        self.cursor += 1
        if self.injector is not None:
            recs = self.injector.on_stream_batch(idx, recs)
        before = dict(self.ingest.counters)
        admitted = self.ingest.process(recs)      # may raise PoisonRecord
        deltas = {r: self.ingest.counters[r] - before[r]
                  for r in before if self.ingest.counters[r] > before[r]}
        if deltas:
            self._emit("record_quarantined", batch=idx,
                       total=int(sum(deltas.values())), **deltas)
        shed = self.window.stage(admitted)  # may raise BackpressureOverflow
        if shed:
            self._emit("backpressure", batch=idx, kind="queue_shed",
                       shed=int(shed))
        return idx

    def _insert(self, recs: Records, dirty: set) -> None:
        c = self.config
        T, M = c.t_cap, c.m_cap
        for i in range(recs.n):
            obj = int(recs.obj[i])
            r = self._row_of.get(obj)
            if r is None:
                free = np.nonzero(self.obj_of_row < 0)[0]
                if free.size == 0:
                    if self.window.policy == "block":
                        raise BackpressureOverflow(
                            f"window store full ({T} rows) and object "
                            f"{obj} needs a new row")
                    self.shed_capacity += 1
                    self._emit("backpressure", kind="capacity", obj=obj)
                    continue
                r = int(free[0])
                self.obj_of_row[r] = obj
                self._row_of[obj] = r
            n = int(np.sum(self.valid[r]))
            if n >= M:
                # drop the row's oldest point to admit the new one
                self.xs[r, :M - 1] = self.xs[r, 1:]
                self.ys[r, :M - 1] = self.ys[r, 1:]
                self.ts[r, :M - 1] = self.ts[r, 1:]
                n = M - 1
                self.valid[r, :] = False
                self.valid[r, :n] = True
                self.row_overflow += 1
            pos = int(np.searchsorted(self.ts[r, :n],
                                      np.float32(recs.t[i]), side="right"))
            # np.insert allocates a fresh row — safe for the overlapping
            # shift an in-place slice assignment would corrupt
            self.xs[r, :n + 1] = np.insert(self.xs[r, :n], pos, recs.x[i])
            self.ys[r, :n + 1] = np.insert(self.ys[r, :n], pos, recs.y[i])
            self.ts[r, :n + 1] = np.insert(self.ts[r, :n], pos, recs.t[i])
            self.valid[r, n] = True
            self.inserted_total += 1
            dirty.add(r)

    def _evict(self, dirty: set) -> int:
        cutoff = self.window.evict_before()
        if not np.isfinite(cutoff):
            return 0
        evicted = 0
        for r in range(self.config.t_cap):
            if self.obj_of_row[r] < 0:
                continue
            n = int(np.sum(self.valid[r]))
            keep = self.ts[r, :n] >= np.float32(cutoff)
            kn = int(np.sum(keep))
            if kn == n:
                continue
            evicted += n - kn
            self.xs[r, :kn] = self.xs[r, :n][keep]
            self.ys[r, :kn] = self.ys[r, :n][keep]
            self.ts[r, :kn] = self.ts[r, :n][keep]
            self.xs[r, kn:] = 0.0
            self.ys[r, kn:] = 0.0
            self.ts[r, kn:] = 0.0
            self.valid[r, :] = False
            self.valid[r, :kn] = True
            dirty.add(r)
            if kn == 0:
                del self._row_of[int(self.obj_of_row[r])]
                self.obj_of_row[r] = -1
        self.evicted_points += evicted
        return evicted

    def _update_bboxes(self, rows) -> None:
        for r in rows:
            v = self.valid[r]
            if not v.any():
                self.bx_min[r] = self.by_min[r] = self.bt_min[r] = np.inf
                self.bx_max[r] = self.by_max[r] = self.bt_max[r] = -np.inf
                self.b_nonempty[r] = False
                continue
            self.bx_min[r] = self.xs[r][v].min()
            self.bx_max[r] = self.xs[r][v].max()
            self.by_min[r] = self.ys[r][v].min()
            self.by_max[r] = self.ys[r][v].max()
            self.bt_min[r] = self.ts[r][v].min()
            self.bt_max[r] = self.ts[r][v].max()
            self.b_nonempty[r] = True

    def _boxes(self, rows=None) -> TileBoxes:
        sel = slice(None) if rows is None else rows
        f = lambda a: torch.from_numpy(a[sel]).to(self.device)
        return TileBoxes(xmin=f(self.bx_min), xmax=f(self.bx_max),
                         ymin=f(self.by_min), ymax=f(self.by_max),
                         tmin=f(self.bt_min), tmax=f(self.bt_max),
                         nonempty=f(self.b_nonempty))

    def window_batch(self) -> TrajectoryBatch:
        """The active window as a batch on the driver's device — the
        oracle cross-check feeds this straight into ``run_dsc``."""
        return TrajectoryBatch.from_arrays(
            self.xs, self.ys, self.ts, self.valid,
            self.obj_of_row.astype(np.int32), device=self.device)

    # -------------------------------------------------------- delta join
    def _delta_join(self, D: np.ndarray, win: TrajectoryBatch) -> None:
        """Recompute the cube's dirty rows and columns (both directions):
        K1 on the card, the plain join under the bbox pair mask on the
        CPU; in chunks of dirty rows so that no output stands beside the
        cube at full size."""
        c = self.config
        T, M = c.t_cap, c.m_cap
        rows_t = torch.from_numpy(D).to(self.device)
        per = max(1, JOIN_ELEMENTS // (M * T))
        cuda = self.device.type == "cuda"
        if cuda:
            from repro_torch.kernels.stjoin.ops import best_match_join_kernel
        else:
            mask = exact_pair_mask(self._boxes(D), self._boxes(),
                                   np.float32(c.eps_sp), np.float32(c.eps_t))
        for i in range(0, D.size, per):
            r = rows_t[i:i + per]
            sub = TrajectoryBatch(x=win.x[r], y=win.y[r], t=win.t[r],
                                  valid=win.valid[r],
                                  traj_id=win.traj_id[r])
            if cuda:
                fwd = best_match_join_kernel(sub, win, c.eps_sp, c.eps_t)
                rev = best_match_join_kernel(win, sub, c.eps_sp, c.eps_t)
            else:
                m = mask[i:i + per]
                fwd = best_match_join(sub, win, c.eps_sp, c.eps_t,
                                      prune_mask=m)
                rev = best_match_join(win, sub, c.eps_sp, c.eps_t,
                                      prune_mask=m.T)
            if c.delta_t > 0.0:
                fwd = filter_delta_t(fwd, sub.t, c.delta_t)
                rev = filter_delta_t(rev, win.t, c.delta_t)
            self.cube_w.index_copy_(0, r, fwd.best_w)
            self.cube_idx.index_copy_(0, r, fwd.best_idx)
            del fwd
            self.cube_w.index_copy_(2, r, rev.best_w)
            self.cube_idx.index_copy_(2, r, rev.best_idx)
            del rev

    # -------------------------------------------------------- fresh block
    def _fresh_block(self, rows: np.ndarray, with_cand: bool):
        """Exact similarity rows AND columns of the slots of ``rows``
        (ascending), from the cube.

        The forward raw scatter takes the rows' cube entries, the reverse
        one the rows' cube columns, each through ``scatter_raw`` (per-cell
        ``(m, c)`` order, as the batch path adds); ``max(fwd, rev)``
        normalized by ``min(card)`` equals the batch path's
        divide-then-max (the denominator is symmetric and IEEE division by
        a positive value is monotone).

        Returns ``(slots [Sd], fresh_ids / fresh_sims [Sd, kk], cand_ids /
        cand_sims [S, kc])``: the slots' own top-``kk`` lists and, for
        every window slot, the canonical top-``kc`` candidates coming from
        these slots (what clean rows fold into their purged lists; a value
        dropped there is below ``kc`` candidates already kept).  ``cand_*``
        are None without ``with_cand``.
        """
        c = self.config
        T, mS, S, kk = c.t_cap, c.max_subs, self.S, self.kk
        dev = self.device
        kc = min(kk, _pow2_bucket(max(rows.size, 1), T) * mS)
        gid = slot_ids(self.sub_local, mS, S)
        # the chunk's [rows, S] similarity slabs and its [rows, M, T] /
        # [T, M, rows] gathers of the cube, each bounded
        per = max(1, min(FRESH_ELEMENTS // (mS * S),
                         JOIN_ELEMENTS // (c.m_cap * T)))
        cols = torch.arange(S, device=dev)
        slots_all, f_ids, f_sims = [], [], []
        cand_ids = cand_sims = None
        for r in _chunks(torch.from_numpy(rows).to(dev), per):
            nS = r.shape[0] * mS
            lgid = slot_ids(self.sub_local[r], mS, nS)
            fwd = scatter_raw(self.cube_w[r], self.cube_idx[r], lgid, gid,
                              nS, S)
            rev = scatter_raw(self.cube_w[:, :, r], self.cube_idx[:, :, r],
                              gid, lgid, S, nS, transpose=True)
            slots = (r[:, None] * mS + torch.arange(mS, device=dev)
                     ).reshape(-1)
            denom = torch.minimum(self.card[slots][:, None],
                                  self.card[None, :]).clamp_min(1)
            sim = torch.maximum(fwd, rev) / denom.to(torch.float32)
            del fwd, rev, denom
            keep = (self.tvalid[slots][:, None] & self.tvalid[None, :]
                    & (slots[:, None] != cols[None, :]))
            sim = torch.where(keep, sim, 0.0)
            del keep
            vals, idx = _desc(sim, kk)
            slots_all.append(slots.to(torch.int32))
            f_ids.append(torch.where(vals > 0.0, idx, -1).to(torch.int32))
            f_sims.append(vals.clamp_min(0.0))
            if with_cand:
                cvals, cidx = _desc(sim.T, min(kc, nS))
                ids = torch.where(cvals > 0.0, slots[cidx],
                                  -1).to(torch.int32)
                sims = cvals.clamp_min(0.0)
                if cand_ids is not None:
                    ids, sims = sort_topk_lists(
                        torch.cat([cand_ids, ids], dim=1),
                        torch.cat([cand_sims, sims], dim=1), kc)
                cand_ids, cand_sims = ids, sims
            del sim
        if with_cand and cand_ids.shape[1] < kc:
            pad = kc - cand_ids.shape[1]
            cand_ids = torch.nn.functional.pad(cand_ids, (0, pad), value=-1)
            cand_sims = torch.nn.functional.pad(cand_sims, (0, pad))
        return (torch.cat(slots_all), torch.cat(f_ids), torch.cat(f_sims),
                cand_ids, cand_sims)

    def _merge_standing(self, slots, fresh_ids, fresh_sims, cand_ids,
                        cand_sims, dirty_slot):
        """Fold a fresh block into the standing ``[S, kk]`` lists.

        Dirty slots take their fresh lists outright.  Clean slots purge
        neighbors that are dirty or no longer valid, then merge the fresh
        column candidates via the canonical two-key order (a set function,
        so the result is independent of how evidence arrived).  ``stale``
        marks clean rows whose post-merge list cannot be proven complete
        (full before the purge, lost entries, and the new tail does not
        beat the old one) — recomputed outright in a second pass.
        """
        S, kk = self.standing_ids.shape
        ids0, sims0, tv = self.standing_ids, self.standing_sims, self.tvalid
        sl = slots.long()
        f_ids = torch.full((S, kk), -1, dtype=torch.int32, device=self.device)
        f_sims = torch.zeros((S, kk), dtype=torch.float32, device=self.device)
        f_ids[sl] = fresh_ids
        f_sims[sl] = fresh_sims

        sid = ids0.clamp(0, S - 1).long()
        purge = (ids0 >= 0) & (dirty_slot[sid] | ~tv[sid])
        full_before = (ids0 >= 0).sum(dim=1) == kk
        v_min = sims0[:, kk - 1]
        purged_ids = torch.where(purge, -1, ids0)
        purged_sims = torch.where(purge, 0.0, sims0)
        purged_any = purge.any(dim=1)

        m_ids, m_sims = sort_topk_lists(
            torch.cat([purged_ids, cand_ids], dim=1),
            torch.cat([purged_sims, cand_sims], dim=1), kk)
        m_ids = torch.where(m_sims > 0.0, m_ids, -1)
        m_sims = m_sims.clamp_min(0.0)

        new_ids = torch.where(dirty_slot[:, None], f_ids, m_ids)
        new_sims = torch.where(dirty_slot[:, None], f_sims, m_sims)
        new_ids = torch.where(tv[:, None], new_ids, -1)
        new_sims = torch.where(tv[:, None], new_sims, 0.0)

        stale = (~dirty_slot & tv & full_before & purged_any
                 & (new_sims[:, kk - 1] <= v_min))
        changed = ((new_ids != ids0) | (new_sims != sims0)).any(dim=1)
        return new_ids, new_sims, stale, changed

    def _scatter_fresh(self, ids0, sims0, slots, fresh_ids, fresh_sims):
        """Pass 2: overwrite the stale rows with their recomputed lists."""
        new_ids, new_sims = ids0.clone(), sims0.clone()
        new_ids[slots.long()] = fresh_ids
        new_sims[slots.long()] = fresh_sims
        tv = self.tvalid[:, None]
        new_ids = torch.where(tv, new_ids, -1)
        new_sims = torch.where(tv, new_sims, 0.0)
        changed = ((new_ids != ids0) | (new_sims != sims0)).any(dim=1)
        return new_ids, new_sims, changed

    # ------------------------------------------------------- clustering
    def _cluster_warm(self, table: SubtrajTable, row_changed):
        """Warm-started round-parallel Algorithm 4 over the standing
        lists: the visit-order prefix ``[0, r*)`` — every slot ranked
        before the first slot whose (rank, potential, list) changed — is
        seeded as resolved with its previous verdict (a slot's verdict
        depends only on earlier-ranked slots).  The zeroed degree/moment
        fields are never read: the thresholds are absolute."""
        c = self.config
        S, kk, K = self.S, self.kk, self.K
        ids, sims = self.standing_ids, self.standing_sims
        dev = self.device
        spill = (sims[:, K] if kk > K
                 else torch.zeros((S,), dtype=torch.float32, device=dev))
        zi = torch.zeros((S,), dtype=torch.int32, device=dev)
        zf = torch.zeros((S,), dtype=torch.float32, device=dev)
        # K8 and K9 read whole [S, K] rows: the lists without the spill
        # column, packed
        topk = TopKSim(ids=ids[:, :K].contiguous(),
                       sims=sims[:, :K].contiguous(), spill=spill,
                       degree=zi, row_sum=zf, row_sumsq=zf)
        params = c.params
        _, rank = visit_order(table)
        potential = table.valid & (table.voting >= params.k_abs)
        flagged = ((rank != self.prev_rank)
                   | (potential != self.prev_potential) | row_changed)
        if self.has_prev and c.warm_start:
            r_star = torch.where(flagged, rank, S).min()
        else:
            r_star = torch.zeros((), dtype=torch.int32, device=dev)
        seed_resolved = rank < r_star
        seed_is_rep = self.prev_is_rep & seed_resolved
        result, rounds = cluster_rounds_topk(
            topk, table, params, with_rounds=True,
            use_kernel=dev.type == "cuda",
            seed_resolved=seed_resolved, seed_is_rep=seed_is_rep)
        overflow = topk_overflow(topk, result.alpha_used)
        return (result, rounds, rank, potential, overflow,
                int(seed_resolved.sum()))

    # ------------------------------------------------------------- advance
    def advance(self) -> dict:
        """Drain the staging queue and bring every piece of standing
        state up to date with the new window contents."""
        c = self.config
        if self.injector is not None:
            self.injector.on_window_advance(self.advance_count)
        admitted, n_late = self.window.drain()    # may raise WatermarkStall
        if n_late:
            self._emit("late_dropped", advance=self.advance_count,
                       dropped=int(n_late),
                       watermark=float(self.window.watermark))

        dirty: set = set()
        inserted_before = self.inserted_total
        self._insert(admitted, dirty)
        inserted = self.inserted_total - inserted_before
        evicted = self._evict(dirty)

        if not dirty:
            self.advance_count += 1
            self._emit("window_advanced", advance=self.advance_count - 1,
                       watermark=float(self.window.watermark),
                       admitted=int(admitted.n), late=int(n_late),
                       inserted=0, evicted=0, dirty_rows=0, sim_rows=0,
                       pass2_rows=0, rounds=int(self.last_rounds),
                       warm_prefix=int(self.warm_prefix), noop=True,
                       reps=int(self.is_rep.sum()),
                       outliers=int(self.is_outlier.sum()), overflow=0)
            self._maybe_snapshot()
            return {"advance": self.advance_count - 1, "dirty_rows": 0,
                    "noop": True}

        D = np.asarray(sorted(dirty), np.int64)
        self._update_bboxes(D)
        win = self.window_batch()

        # --- delta join ----------------------------------------------------
        self._delta_join(D, win)

        # --- vote / segmentation / ST (run_dsc's stage bodies) --------------
        params = c.params
        old_sub = self.sub_local
        vote, masks = dsc_mod._vote_from_join_body(
            params, JoinResult(best_w=self.cube_w, best_idx=self.cube_idx))
        seg, table = dsc_mod._segment_body(
            win, params, vote, masks,
            EnginePlan(seg_use_kernel=self.device.type == "cuda"))
        del masks
        self.vote, self.sub_local = vote, seg.sub_local
        self.t_start, self.t_end = table.t_start, table.t_end
        self.voting, self.card, self.tvalid = (table.voting, table.card,
                                               table.valid)

        struct_dirty = torch.nonzero(
            (self.sub_local != old_sub).any(dim=1))[:, 0].cpu().numpy()
        D_sim = np.union1d(D, struct_dirty).astype(np.int64)

        # --- similarity: fresh block + standing merge ------------------------
        dirty_slot = torch.zeros((self.S,), dtype=torch.bool,
                                 device=self.device)
        dirty_slot.view(c.t_cap, c.max_subs)[
            torch.from_numpy(D_sim).to(self.device)] = True
        slots, f_ids, f_sims, cd_ids, cd_sims = self._fresh_block(
            D_sim, with_cand=True)
        new_ids, new_sims, stale, changed = self._merge_standing(
            slots, f_ids, f_sims, cd_ids, cd_sims, dirty_slot)
        del f_ids, f_sims, cd_ids, cd_sims

        pass2_rows = 0
        stale_slots = torch.nonzero(stale)[:, 0]
        if stale_slots.numel():
            # recompute stale rows outright; pass 2 purges nothing, so it
            # cannot create new staleness — two passes always suffice
            rows2 = np.unique(stale_slots.cpu().numpy() // c.max_subs)
            pass2_rows = int(rows2.size)
            slot2, f2_ids, f2_sims, _, _ = self._fresh_block(
                rows2.astype(np.int64), with_cand=False)
            new_ids, new_sims, changed2 = self._scatter_fresh(
                new_ids, new_sims, slot2, f2_ids, f2_sims)
            changed = changed | changed2

        self.standing_ids, self.standing_sims = new_ids, new_sims

        # --- clustering (warm-started) ------------------------------------
        result, rounds, rank, potential, overflow, warm_n = \
            self._cluster_warm(table, changed)
        self.member_of = result.member_of
        self.member_sim = result.member_sim
        self.is_rep = result.is_rep
        self.is_outlier = result.is_outlier
        self.alpha = float(result.alpha_used)
        self.k_used = float(result.k_used)
        self.last_rounds = int(rounds)
        self.warm_prefix = int(warm_n)
        self.prev_rank = rank
        self.prev_potential = potential
        self.prev_is_rep = self.is_rep.clone()
        self.has_prev = True
        n_over = int(int(overflow) > 0)
        if n_over:
            self.overflow_events += 1

        summary = {
            "advance": self.advance_count,
            "watermark": float(self.window.watermark),
            "admitted": int(admitted.n), "late": int(n_late),
            "inserted": int(inserted), "evicted": int(evicted),
            "dirty_rows": int(D.size), "sim_rows": int(D_sim.size),
            "pass2_rows": pass2_rows, "rounds": int(rounds),
            "warm_prefix": int(warm_n),
            "reps": int(self.is_rep.sum()),
            "outliers": int(self.is_outlier.sum()),
            "overflow": n_over,
        }
        self._emit("window_advanced", **summary)
        self.advance_count += 1
        self._maybe_snapshot()
        return summary

    # ------------------------------------------------------------ snapshots
    def _maybe_snapshot(self):
        if (self.manager is not None and self.config.snapshot_every
                and self.advance_count % self.config.snapshot_every == 0):
            self.snapshot()

    def snapshot(self):
        """Full-state snapshot at an advance boundary (queue must be
        empty — the submission cursor replays anything staged later), in
        the reference's tree paths and dtypes."""
        if self.window.queued() > 0:
            raise RuntimeError(
                "snapshot with a non-empty staging queue would lose "
                f"{self.window.queued()} records: advance() first")
        if self.manager is None:
            raise RuntimeError("no checkpoint_dir configured")
        tree = {
            "store": {"obj": self.obj_of_row, "x": self.xs, "y": self.ys,
                      "t": self.ts, "valid": self.valid},
            "cube": {"w": self.cube_w, "idx": self.cube_idx},
            "seg": {"sub_local": self.sub_local},
            "vote": {"vote": self.vote},
            "bbox": {"xmin": self.bx_min, "xmax": self.bx_max,
                     "ymin": self.by_min, "ymax": self.by_max,
                     "tmin": self.bt_min, "tmax": self.bt_max,
                     "nonempty": self.b_nonempty},
            "standing": {"ids": self.standing_ids,
                         "sims": self.standing_sims},
            "table": {"t_start": self.t_start, "t_end": self.t_end,
                      "voting": self.voting, "card": self.card,
                      "valid": self.tvalid},
            "labels": {"member_of": self.member_of,
                       "member_sim": self.member_sim,
                       "is_rep": self.is_rep,
                       "is_outlier": self.is_outlier,
                       "thresholds": np.asarray(
                           [self.alpha, self.k_used], np.float32)},
            "warm": {"prev_rank": self.prev_rank,
                     "prev_potential": self.prev_potential,
                     "prev_is_rep": self.prev_is_rep,
                     "has_prev": np.asarray([self.has_prev])},
            "driver": {"scalars": np.asarray(
                [self.advance_count, self.cursor, self.evicted_points,
                 self.shed_capacity, self.row_overflow,
                 self.overflow_events, self.inserted_total], np.int64)},
            "ingest": self.ingest.state_arrays(),
            "window": self.window.state_arrays(),
        }
        self.manager.save(self.advance_count, tree, meta={
            "schema": STREAM_SNAPSHOT_SCHEMA,
            "fingerprint": self.config.fingerprint()})

    def maybe_resume(self) -> bool:
        """Restore the newest valid snapshot, falling back step by step
        past corrupt ones.  Returns True when state was restored."""
        if self.manager is None:
            return False
        steps = self.manager.available_steps()
        if not steps:
            return False
        for step in reversed(steps):
            meta = checkpoint_meta(self.manager.root, step)
            if not meta or meta.get("schema") != STREAM_SNAPSHOT_SCHEMA \
                    or meta.get("fingerprint") != self.config.fingerprint():
                raise ValueError(
                    f"snapshot step {step} was written under a different "
                    "schema/config — refusing to resume into it")
            try:
                flat, _ = self.manager.restore_flat(step)
            except IOError:
                continue             # corrupt leaves: fall back a step
            self._load(flat)
            return True
        return False

    def _load(self, flat: dict):
        dev = self.device
        on = lambda k: torch.from_numpy(flat[k]).to(dev)
        self.obj_of_row = flat["store/obj"].astype(np.int64)
        self.xs = flat["store/x"]
        self.ys = flat["store/y"]
        self.ts = flat["store/t"]
        self.valid = flat["store/valid"].astype(bool)
        self._row_of = {int(o): r for r, o in enumerate(self.obj_of_row)
                        if o >= 0}
        self.cube_w = on("cube/w")
        self.cube_idx = on("cube/idx")
        self.sub_local = on("seg/sub_local")
        self.vote = on("vote/vote")
        self.bx_min = flat["bbox/xmin"]
        self.bx_max = flat["bbox/xmax"]
        self.by_min = flat["bbox/ymin"]
        self.by_max = flat["bbox/ymax"]
        self.bt_min = flat["bbox/tmin"]
        self.bt_max = flat["bbox/tmax"]
        self.b_nonempty = flat["bbox/nonempty"].astype(bool)
        self.standing_ids = on("standing/ids")
        self.standing_sims = on("standing/sims")
        self.t_start = on("table/t_start")
        self.t_end = on("table/t_end")
        self.voting = on("table/voting")
        self.card = on("table/card")
        self.tvalid = on("table/valid")
        self.member_of = on("labels/member_of")
        self.member_sim = on("labels/member_sim")
        self.is_rep = on("labels/is_rep")
        self.is_outlier = on("labels/is_outlier")
        self.alpha = float(flat["labels/thresholds"][0])
        self.k_used = float(flat["labels/thresholds"][1])
        self.prev_rank = on("warm/prev_rank")
        self.prev_potential = on("warm/prev_potential")
        self.prev_is_rep = on("warm/prev_is_rep")
        self.has_prev = bool(flat["warm/has_prev"][0])
        (self.advance_count, self.cursor, self.evicted_points,
         self.shed_capacity, self.row_overflow, self.overflow_events,
         self.inserted_total) = (int(v) for v in flat["driver/scalars"])
        self.ingest.load_state_arrays(
            {k.split("/", 1)[1]: v for k, v in flat.items()
             if k.startswith("ingest/")})
        self.window.load_state_arrays(
            {k.split("/", 1)[1]: v for k, v in flat.items()
             if k.startswith("window/")})

    # -------------------------------------------------------------- queries
    def query(self, obj: int) -> dict:
        """Current subtrajectories + cluster assignment of one object."""
        c = self.config
        out = {"obj": int(obj), "in_window": False,
               "watermark": float(self.window.watermark), "subtrajs": []}
        r = self._row_of.get(int(obj))
        if r is None:
            return out
        out["in_window"] = True
        s0, s1 = r * c.max_subs, (r + 1) * c.max_subs
        tvalid, t_start, t_end, is_rep, is_out, member_of, member_sim = (
            a[s0:s1].tolist() for a in (
                self.tvalid, self.t_start, self.t_end, self.is_rep,
                self.is_outlier, self.member_of, self.member_sim))
        for s in range(c.max_subs):
            if not tvalid[s]:
                continue
            entry = {"sub": s, "slot": s0 + s,
                     "t_start": float(t_start[s]),
                     "t_end": float(t_end[s]),
                     "is_rep": bool(is_rep[s]),
                     "is_outlier": bool(is_out[s]),
                     "cluster": None}
            rep = int(member_of[s])
            if rep >= 0:
                entry["cluster"] = {
                    "rep_obj": int(self.obj_of_row[rep // c.max_subs]),
                    "rep_sub": rep % c.max_subs, "rep_slot": rep,
                    "sim": float(member_sim[s])}
            out["subtrajs"].append(entry)
        return out

    def stats(self) -> dict:
        return {
            "advances": self.advance_count,
            "cursor": self.cursor,
            "watermark": float(self.window.watermark),
            "objects": len(self._row_of),
            "points": int(np.sum(self.valid)),
            "submitted": self.ingest.submitted,
            "admitted": self.ingest.admitted,
            "quarantined": dict(self.ingest.counters),
            "repaired_order": self.ingest.repaired_order,
            "late_dropped": self.window.late_dropped,
            "shed_queue": self.window.shed,
            "shed_capacity": self.shed_capacity,
            "row_overflow": self.row_overflow,
            "inserted": self.inserted_total,
            "evicted": self.evicted_points,
            "reps": int(self.is_rep.sum()),
            "outliers": int(self.is_outlier.sum()),
            "overflow_events": self.overflow_events,
            "last_rounds": self.last_rounds,
            "warm_prefix": self.warm_prefix,
        }

    def accounting(self) -> dict:
        """The no-silent-drops invariant: every submitted record is
        admitted into the store, quarantined, dropped late, shed, or
        still staged — and the books must balance exactly."""
        lhs = self.ingest.submitted
        rhs = (self.ingest.quarantined_total() + self.window.late_dropped
               + self.window.shed + self.shed_capacity
               + self.inserted_total + self.window.queued())
        return {"submitted": int(lhs),
                "quarantined": int(self.ingest.quarantined_total()),
                "late_dropped": int(self.window.late_dropped),
                "shed_queue": int(self.window.shed),
                "shed_capacity": int(self.shed_capacity),
                "inserted": int(self.inserted_total),
                "queued": int(self.window.queued()),
                "balanced": bool(lhs == rhs)}
