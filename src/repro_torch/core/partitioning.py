"""Temporal equi-depth partitioning (the paper's Repartitioning phase) —
counterpart of ``repro.core.partitioning``.

Host-side preprocessing, done once per dataset (paper Sec. 4.2): an
equi-depth histogram over the temporal dimension (every bin holds about the
same number of points), then a *row-aligned* layout: partition p holds, for
every global trajectory row r, the points of r that fall in p's time range,
padded to ``Mp``.  Row alignment turns the MapReduce group-by-trajectory
shuffle into one static ``all_to_all`` (``core/distributed.py``).

The layout is computed in numpy on the host, bit for bit the reference's;
the slabs of a :class:`PartitionedBatch` are torch tensors on the device of
the batch they were cut from.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import TrajectoryBatch


def _np(a) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


@dataclasses.dataclass
class PartitionedBatch:
    """Row-aligned temporal partitions: ``[P, T, Mp]`` point slabs.

    ``edges`` / ``src_m`` record the layout that produced the slabs (the
    cut edges, float64 so boundary classification survives a round-trip,
    and each slot's source column in the ``[T, M]`` batch).  They are host
    numpy arrays; ``None`` on hand-built batches — repartitioning requires
    them.
    """

    x: torch.Tensor        # [P, T, Mp] float32
    y: torch.Tensor        # [P, T, Mp]
    t: torch.Tensor        # [P, T, Mp]
    valid: torch.Tensor    # [P, T, Mp] bool
    traj_id: torch.Tensor  # [T] int32 global ids (-1 padding rows)
    ranges: torch.Tensor   # [P, 2] float32 (t_lo, t_hi) per partition
    edges: np.ndarray | None = None   # [P+1] float64 cut edges (±inf outer)
    src_m: np.ndarray | None = None   # [P, T, Mp] int32 source column (-1 pad)

    @property
    def num_partitions(self) -> int:
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def to(self, device) -> "PartitionedBatch":
        """The same partitions with every slab on ``device``."""
        move = lambda a: a.to(device)
        return dataclasses.replace(
            self, x=move(self.x), y=move(self.y), t=move(self.t),
            valid=move(self.valid), traj_id=move(self.traj_id),
            ranges=move(self.ranges))


def _float_order_bits(i: np.ndarray) -> np.ndarray:
    """Monotone involution on float64 *bit patterns* (IEEE-754 total
    order): ``bits ^ ((bits >> 63) & 0x7FF...F)`` sorts int64 keys as the
    floats they encode, and decodes keys back to bits."""
    i = np.asarray(i, np.int64)
    return i ^ ((i >> 63) & np.int64(0x7FFFFFFFFFFFFFFF))


def _float_rank(v: np.ndarray) -> np.ndarray:
    """float64 -> int64 rank with ``np.nextafter(x, inf) == rank(x) + 1``
    for every ``x < inf`` (the two zero keys merged)."""
    key = _float_order_bits(np.asarray(v, np.float64).view(np.int64))
    return key + (key < 0)


def _rank_float(rank: np.ndarray) -> np.ndarray:
    key = np.where(rank >= 0, rank, rank - 1)
    return _float_order_bits(key).view(np.float64)


def equi_depth_edges(times: np.ndarray, P: int,
                     sample: int | None = 100_000,
                     seed: int = 0) -> np.ndarray:
    """Equi-depth bin edges from a seeded sample of the valid timestamps.

    Duplicate edges on skewed data are bumped apart: the sequential rule
    ``r[i] = max(qs[i], nextafter(r[i-1]))`` is, in rank space, one
    ``maximum.accumulate``."""
    times = _np(times).ravel()
    if sample is not None and times.size > sample:
        rng = np.random.default_rng(seed)
        times = rng.choice(times, size=sample, replace=False)
    qs = np.quantile(times, np.linspace(0.0, 1.0, P + 1))
    qs[0], qs[-1] = -np.inf, np.inf
    rank = _float_rank(qs[:P])
    idx = np.arange(P, dtype=np.int64)
    qs[:P] = _rank_float(np.maximum.accumulate(rank - idx) + idx)
    return qs.astype(np.float64)


def _layout_fields(t: np.ndarray, valid: np.ndarray, edges: np.ndarray,
                   P: int):
    """The deterministic (row, column) -> (partition, slot) map: ``(order,
    p_of, r_of, slot, counts)`` over the valid points in (p, r, m) order;
    ``counts`` is the ``[P, T]`` cell histogram."""
    T, M = t.shape
    pidx = np.searchsorted(edges, t, side="right") - 1
    pidx = np.clip(pidx, 0, P - 1)
    pidx = np.where(valid, pidx, -1)
    rows = np.broadcast_to(np.arange(T)[:, None], (T, M))
    flat = np.nonzero(valid.ravel())[0]
    order = flat[np.argsort(pidx.ravel()[flat], kind="stable")]
    p_of = pidx.ravel()[order]
    r_of = rows.ravel()[order]
    grp = p_of * T + r_of
    counts = np.bincount(grp, minlength=P * T).reshape(P, T)
    start = np.concatenate(([0], np.cumsum(counts.ravel())))[grp]
    slot = np.arange(order.size) - start
    return order, p_of, r_of, slot, counts


def _pad_mp(counts: np.ndarray, pad_mp_to: int) -> int:
    Mp = int(counts.max(initial=1))
    return max(pad_mp_to, ((Mp + pad_mp_to - 1) // pad_mp_to) * pad_mp_to)


def partition_batch(batch: TrajectoryBatch, P: int, *, pad_mp_to: int = 8,
                    sample: int | None = 100_000) -> PartitionedBatch:
    """Split a TrajectoryBatch into P row-aligned temporal partitions, on
    the batch's device."""
    t = _np(batch.t)
    v = _np(batch.valid)
    edges = equi_depth_edges(t[v], P, sample=sample)
    return _scatter_batch(_np(batch.x), _np(batch.y), t, v, batch.traj_id,
                          edges, P, pad_mp_to=pad_mp_to)


def _scatter_batch(x, y, t, v, traj_id, edges, P, *,
                   pad_mp_to: int = 8) -> PartitionedBatch:
    """Scatter global ``[T, M]`` host arrays into the layout of ``edges``
    (the core of :func:`partition_batch` and :func:`repartition_batch`);
    the slabs land on ``traj_id``'s device."""
    T, M = x.shape
    order, p_of, r_of, slot, counts = _layout_fields(t, v, edges, P)
    Mp = _pad_mp(counts, pad_mp_to)

    px = np.zeros((P, T, Mp), np.float32)
    py = np.zeros((P, T, Mp), np.float32)
    pt = np.zeros((P, T, Mp), np.float32)
    pv = np.zeros((P, T, Mp), bool)
    src_m = np.full((P, T, Mp), -1, np.int32)
    px[p_of, r_of, slot] = x.ravel()[order]
    py[p_of, r_of, slot] = y.ravel()[order]
    pt[p_of, r_of, slot] = t.ravel()[order]
    pv[p_of, r_of, slot] = True
    src_m[p_of, r_of, slot] = order - r_of * M

    finite_lo = np.where(np.isfinite(edges[:-1]), edges[:-1],
                         t[v].min() - 1.0)
    finite_hi = np.where(np.isfinite(edges[1:]), edges[1:], t[v].max() + 1.0)
    ranges = np.stack([finite_lo, finite_hi], axis=1).astype(np.float32)

    dev = traj_id.device
    on = lambda a: torch.from_numpy(a).to(dev)
    return PartitionedBatch(
        x=on(px), y=on(py), t=on(pt), valid=on(pv),
        traj_id=traj_id.to(torch.int32), ranges=on(ranges),
        edges=np.asarray(edges, np.float64), src_m=src_m)


# --------------------------------------------------------------------------
# Canonical global form: gather / repartition (the reference's DESIGN.md
# §11).  Every per-point stage leaf ``[P, T, Mp, ...]`` is laid out by the
# map above, so folding it back to global ``[T, M, ...]`` point space, and
# re-cutting it for another P or other edges, needs only ``(t, valid,
# edges)``.  ``kind="point"`` leaves ride with their point; ``kind=
# "cand_idx"`` leaves index the join's halo slab ``[own | p-1 | p+1]``
# (3*Mp columns) and translate through the candidate point's global
# identity (an out-of-halo candidate maps to column 0: only entries of
# weight 0 reach it, and they are bit-inert downstream).
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PointLayout:
    """The (row, column) -> (partition, slot) map of one row-aligned
    temporal layout, recomputable from ``(t, valid, edges)`` alone."""

    edges: np.ndarray    # [P+1] float64
    t: np.ndarray        # [T, M] global timestamps (float32)
    valid: np.ndarray    # [T, M] bool
    Mp: int
    p_of: np.ndarray     # [n_valid] partition per point (layout order)
    r_of: np.ndarray     # [n_valid] row per point
    m_of: np.ndarray     # [n_valid] global column per point
    slot: np.ndarray     # [n_valid] slot within the (p, r) cell
    src_m: np.ndarray    # [P, T, Mp] int32 inverse map (-1 padding)

    @property
    def P(self) -> int:
        return len(self.edges) - 1

    @property
    def T(self) -> int:
        return self.t.shape[0]

    @property
    def M(self) -> int:
        return self.t.shape[1]

    @classmethod
    def from_global(cls, t, valid, edges, *, Mp: int | None = None,
                    pad_mp_to: int = 8) -> "PointLayout":
        t = np.asarray(_np(t), np.float32)
        valid = np.asarray(_np(valid), bool)
        edges = np.asarray(edges, np.float64)
        P = len(edges) - 1
        T, M = t.shape
        order, p_of, r_of, slot, counts = _layout_fields(t, valid, edges, P)
        if Mp is None:
            Mp = _pad_mp(counts, pad_mp_to)
        m_of = order - r_of * M
        src_m = np.full((P, T, Mp), -1, np.int32)
        src_m[p_of, r_of, slot] = m_of
        return cls(edges=edges, t=t, valid=valid, Mp=int(Mp), p_of=p_of,
                   r_of=r_of, m_of=m_of, slot=slot, src_m=src_m)

    @classmethod
    def from_parts(cls, parts: PartitionedBatch) -> "PointLayout":
        """Layout of a ``partition_batch``-produced batch (requires the
        recorded ``edges`` / ``src_m``)."""
        if parts.edges is None or parts.src_m is None:
            raise ValueError(
                "PartitionedBatch carries no layout record (edges/src_m "
                "are None): rebuild it with repro_torch.core.partitioning."
                "partition_batch to enable gather/repartition")
        src = np.asarray(parts.src_m)
        pt = _np(parts.t)
        pv = _np(parts.valid)
        P, T, Mp = src.shape
        M = int(src.max(initial=0)) + 1
        t = np.zeros((T, M), np.float32)
        valid = np.zeros((T, M), bool)
        p, r, s = np.nonzero(pv)
        t[r, src[p, r, s]] = pt[p, r, s]
        valid[r, src[p, r, s]] = True
        return cls.from_global(t, valid, parts.edges, Mp=Mp)

    def same_points(self, other: "PointLayout") -> bool:
        return (self.t.shape == other.t.shape
                and np.array_equal(self.valid, other.valid)
                and np.array_equal(self.t[self.valid],
                                   other.t[other.valid]))

    def same_layout(self, other: "PointLayout") -> bool:
        return (self.same_points(other) and self.Mp == other.Mp
                and np.array_equal(self.edges, other.edges))

    def gather(self, leaf) -> np.ndarray:
        """``[P, T, Mp, ...]`` partitioned leaf -> global ``[T, M, ...]``
        (zeros at invalid positions)."""
        leaf = _np(leaf)
        out = np.zeros((self.T, self.M) + leaf.shape[3:], leaf.dtype)
        out[self.r_of, self.m_of] = leaf[self.p_of, self.r_of, self.slot]
        return out

    def scatter(self, glob) -> np.ndarray:
        """Global ``[T, M, ...]`` -> this layout's ``[P, T, Mp, ...]``."""
        glob = _np(glob)
        out = np.zeros((self.P, self.T, self.Mp) + glob.shape[2:],
                       glob.dtype)
        out[self.p_of, self.r_of, self.slot] = glob[self.r_of, self.m_of]
        return out

    def gather_cand_idx(self, leaf) -> np.ndarray:
        """``[P, T, Mp, ...]`` leaf of slab column indices -> global
        candidate columns (-1 where the slab position holds padding)."""
        leaf = _np(leaf)
        vals = leaf[self.p_of, self.r_of, self.slot]
        block = vals // self.Mp                # 0 own, 1 p-1, 2 p+1
        off = np.where(block == 1, -1, np.where(block == 2, 1, 0))
        q = self.p_of.reshape((-1,) + (1,) * (vals.ndim - 1)) + off
        s = vals % self.Mp
        rc = self._cand_rows(vals.shape)
        ok = (q >= 0) & (q < self.P)
        gm = np.where(ok, self.src_m[np.clip(q, 0, self.P - 1), rc, s], -1)
        out = np.full((self.T, self.M) + leaf.shape[3:], -1, np.int32)
        out[self.r_of, self.m_of] = gm
        return out

    def scatter_cand_idx(self, glob) -> np.ndarray:
        """Global candidate columns -> this layout's slab indices
        (out-of-halo / invalid candidates map to column 0)."""
        glob = _np(glob)
        vals = glob[self.r_of, self.m_of]
        pmap, smap = self._point_ps()
        rc = self._cand_rows(vals.shape)
        ok = vals >= 0
        vc = np.clip(vals, 0, self.M - 1)
        q = np.where(ok, pmap[rc, vc], -1)
        s = smap[rc, vc]
        d = q - self.p_of.reshape((-1,) + (1,) * (vals.ndim - 1))
        j = np.where(d == 0, s,
                     np.where(d == -1, self.Mp + s,
                              np.where(d == 1, 2 * self.Mp + s, 0)))
        j = np.where(ok & (q >= 0), j, 0)
        out = np.zeros((self.P, self.T, self.Mp) + glob.shape[2:],
                       np.int32)
        out[self.p_of, self.r_of, self.slot] = j.astype(np.int32)
        return out

    def _cand_rows(self, shape):
        """Candidate-row index grid for a cube's trailing ``[..., T]``."""
        if len(shape) < 2 or shape[-1] != self.T:
            raise ValueError(
                f"cand_idx leaf trailing shape {shape[1:]} does not end "
                f"in the global row count T={self.T}")
        return np.broadcast_to(np.arange(self.T), shape)

    def _point_ps(self):
        """Inverse maps ``[T, M] -> partition / slot`` (-1 invalid)."""
        pmap = np.full((self.T, self.M), -1, np.int32)
        smap = np.zeros((self.T, self.M), np.int32)
        pmap[self.r_of, self.m_of] = self.p_of
        smap[self.r_of, self.m_of] = self.slot
        return pmap, smap


def gather_global(leaf, layout: PointLayout, *,
                  kind: str = "point") -> np.ndarray:
    """Fold one per-partition ``[P, T, Mp, ...]`` stage leaf to the
    canonical global ``[T, M, ...]`` point space."""
    if kind == "point":
        return layout.gather(leaf)
    if kind == "cand_idx":
        return layout.gather_cand_idx(leaf)
    raise ValueError(f"kind={kind!r}: expected 'point' or 'cand_idx'")


def repartition(leaf, old: PointLayout, new: PointLayout, *,
                kind: str = "point") -> np.ndarray:
    """Re-cut one stage leaf from ``old``'s layout to ``new``'s."""
    if not old.same_points(new):
        raise ValueError("repartition across different point sets: the "
                         "checkpoint and the current batch disagree on "
                         "(t, valid)")
    if kind == "point":
        return new.scatter(old.gather(leaf))
    if kind == "cand_idx":
        return new.scatter_cand_idx(old.gather_cand_idx(leaf))
    raise ValueError(f"kind={kind!r}: expected 'point' or 'cand_idx'")


def repartition_batch(parts: PartitionedBatch, edges,
                      *, pad_mp_to: int = 8) -> PartitionedBatch:
    """Re-cut a partitioned batch at explicit ``edges`` (same P or a new
    one), on the same device."""
    layout = PointLayout.from_parts(parts)
    x = layout.gather(parts.x)
    y = layout.gather(parts.y)
    t = layout.gather(parts.t)
    edges = np.asarray(edges, np.float64)
    return _scatter_batch(x, y, t, layout.valid, parts.traj_id, edges,
                          len(edges) - 1, pad_mp_to=pad_mp_to)
