"""Fixed-resolution spatiotemporal grid index for candidate-tile pruning
(counterpart of ``repro.index.grid``).

The join is the dominant cost of DSC; this filter discards candidate
pairs before they are swept.  It indexes *tiles*: blocks of reference
points and blocks of candidate trajectories, the blocks the join kernels
iterate, and emits, per reference block, the compacted ascending list of
candidate tiles that can possibly contain a match.

Cell-size contract (eps-derived): cells are ``eps_sp x eps_sp x eps_t``,
coarsened only when an axis would need more than ``max_cells_per_axis``
cells (the index gets less selective, never incorrect).

Pruning is two-staged and conservative by construction:

1. coarse -- candidate tiles are bucketed by the grid cell of their bbox
   center; a reference tile keeps the cells overlapping its bbox expanded
   by ``eps + max tile half-extent`` per axis;
2. exact -- surviving tiles are re-checked with the eps-expanded
   bounding-box distance test (Euclidean in space, interval in time), so
   a dropped tile provably holds no matching point pair.

So a pruned join is bit-identical to the dense one.  Numerics follow the
reference op for op: every quantity is float32, a Python scalar is
rounded to float32 before it meets a tensor (as JAX's weak types are),
and ``gx*gx + gy*gy`` rounds the products and the sum separately.  The
scalars are made tensors on the data's device, so a division is IEEE
division on the card too (a CPU scalar would become a reciprocal there).
``fit_grid`` is host code, on CPU copies of the box extents, as in the
reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static grid geometry: origin, cell sizes, cell counts per axis."""

    x0: float
    y0: float
    t0: float
    cell_sp: float       # spatial cell edge (x and y), >= eps_sp
    cell_t: float        # temporal cell extent, >= eps_t
    nx: int
    ny: int
    nt: int

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny * self.nt


@dataclasses.dataclass
class TileBoxes:
    """Per-tile axis-aligned bounding boxes over the *valid* points only."""

    xmin: torch.Tensor    # [n] float32 (+inf for empty tiles)
    xmax: torch.Tensor    # [n] float32 (-inf for empty tiles)
    ymin: torch.Tensor
    ymax: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor
    nonempty: torch.Tensor  # [n] bool -- tile holds >= 1 valid point

    @property
    def num_tiles(self) -> int:
        return self.xmin.shape[0]


@dataclasses.dataclass
class CellTable:
    """CSR-style cell -> tile-id lists (tiles sorted by their center cell).

    ``order[starts[c]:starts[c+1]]`` are the tile ids whose bbox center
    falls in cell ``c``; empty tiles are parked past ``starts[-1]``.
    """

    order: torch.Tensor    # [n] int32 tile ids, cell-sorted
    starts: torch.Tensor   # [num_cells + 1] int32 CSR offsets
    cell_of: torch.Tensor  # [n] int32 center cell id (num_cells for empties)
    coords: torch.Tensor   # [n, 3] int32 (ix, iy, it) center cell coords


@dataclasses.dataclass
class PruneStats:
    """What the index did: dense vs surviving candidate-tile counts."""

    kept_tiles: torch.Tensor   # [] int32 -- sum over ref tiles of survivors
    dense_tiles: int           # n_ref_tiles * n_cand_tiles
    max_per_ref: torch.Tensor  # [] int32 -- most survivors of one ref tile


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


# --------------------------------------------------------------------------
# bbox construction
# --------------------------------------------------------------------------

def _masked_boxes(x, y, t, valid) -> TileBoxes:
    """Min/max over the last axis with invalid slots neutralized."""
    inf = torch.inf
    lo = lambda a: torch.where(valid, a, inf).amin(dim=-1)
    hi = lambda a: torch.where(valid, a, -inf).amax(dim=-1)
    return TileBoxes(xmin=lo(x), xmax=hi(x), ymin=lo(y), ymax=hi(y),
                     tmin=lo(t), tmax=hi(t), nonempty=valid.any(dim=-1))


def point_block_boxes(x, y, t, valid, block: int) -> TileBoxes:
    """Bboxes of consecutive ``block``-point groups of flat ``[P]`` arrays
    (``P % block == 0``)."""
    P = x.shape[0]
    assert P % block == 0, (P, block)
    rs = lambda a: a.reshape(P // block, block)
    return _masked_boxes(rs(x), rs(y), rs(t), rs(valid))


def traj_block_boxes(x, y, t, valid, block: int) -> TileBoxes:
    """Bboxes of ``block`` consecutive trajectory rows of ``[C, Mc]``
    arrays (``C % block == 0``), all their points."""
    C, Mc = x.shape
    assert C % block == 0, (C, block)
    rs = lambda a: a.reshape(C // block, block * Mc)
    return _masked_boxes(rs(x), rs(y), rs(t), rs(valid))


# --------------------------------------------------------------------------
# grid fitting + CSR cell table
# --------------------------------------------------------------------------

def fit_grid(boxes: TileBoxes, eps_sp: float, eps_t: float, *,
             max_cells_per_axis: int = 64) -> GridSpec:
    """Host-side: derive a static GridSpec from concrete tile bboxes.

    Cell sizes start at the matching thresholds and are coarsened only
    when the domain would need more than ``max_cells_per_axis`` cells on
    some axis.  Empty inputs yield a 1-cell grid.
    """
    ne = boxes.nonempty.cpu().numpy()
    eps_sp = float(eps_sp)
    eps_t = float(eps_t)

    def axis(lo_a, hi_a, base):
        if not ne.any():
            return 0.0, max(base, 1e-6), 1
        lo = float(np.min(lo_a.cpu().numpy()[ne]))
        hi = float(np.max(hi_a.cpu().numpy()[ne]))
        cell = max(base, 1e-6)
        extent = max(hi - lo, 0.0)
        n = int(np.floor(extent / cell)) + 1
        if n > max_cells_per_axis:
            cell = extent / max_cells_per_axis * (1 + 1e-6)
            n = int(np.floor(extent / cell)) + 1
        return lo, cell, n

    x0, csx, nx = axis(boxes.xmin, boxes.xmax, eps_sp)
    y0, csy, ny = axis(boxes.ymin, boxes.ymax, eps_sp)
    t0, cst, nt = axis(boxes.tmin, boxes.tmax, eps_t)
    # one spatial resolution for both axes (square cells)
    cell_sp = max(csx, csy)
    return GridSpec(x0=x0, y0=y0, t0=t0, cell_sp=cell_sp, cell_t=cst,
                    nx=nx, ny=ny, nt=nt)


def _cell_index(v, origin, cell, n: int) -> torch.Tensor:
    """``clip(int(floor((v - origin) / cell)), 0, n - 1)`` in float32.
    Clipping before the integer conversion gives the reference's
    convert-then-clip on every finite value; only empty tiles (masked by
    every consumer) see a NaN or an infinity."""
    q = torch.floor((v - _f32(origin, v)) / _f32(cell, v))
    return q.clamp(0, n - 1).to(torch.int32)


def _center_coords(spec: GridSpec, boxes: TileBoxes):
    """Integer cell coords of each tile's bbox center, clipped into range."""
    def quant(lo, hi, origin, cell, n):
        return _cell_index(0.5 * (lo + hi), origin, cell, n)

    ix = quant(boxes.xmin, boxes.xmax, spec.x0, spec.cell_sp, spec.nx)
    iy = quant(boxes.ymin, boxes.ymax, spec.y0, spec.cell_sp, spec.ny)
    it = quant(boxes.tmin, boxes.tmax, spec.t0, spec.cell_t, spec.nt)
    return ix, iy, it


def build_cell_table(spec: GridSpec, boxes: TileBoxes) -> CellTable:
    """Bucket tiles into grid cells (CSR arrays).  The pruning queries
    read only ``coords``; ``order`` / ``starts`` serve consumers that
    gather per-cell tile lists directly."""
    ix, iy, it = _center_coords(spec, boxes)
    cell = (ix * spec.ny + iy) * spec.nt + it
    cell = torch.where(boxes.nonempty, cell, spec.num_cells)   # park empties
    order = torch.argsort(cell, stable=True)
    starts = torch.searchsorted(
        cell[order].long(),
        torch.arange(spec.num_cells + 1, device=cell.device))
    coords = torch.stack([ix, iy, it], dim=-1)
    coords = torch.where(boxes.nonempty[:, None], coords, -1)
    return CellTable(order=order.to(torch.int32),
                     starts=starts.to(torch.int32),
                     cell_of=cell.to(torch.int32),
                     coords=coords.to(torch.int32))


# --------------------------------------------------------------------------
# candidate queries
# --------------------------------------------------------------------------

def _axis_gap(alo, ahi, blo, bhi):
    """Separation between intervals [alo, ahi] and [blo, bhi] (0 =
    overlap); empty boxes' infinite bounds keep their gaps infinite."""
    return torch.maximum(torch.maximum(blo - ahi, alo - bhi),
                         torch.zeros((), dtype=alo.dtype, device=alo.device))


def exact_pair_mask(ref: TileBoxes, cand: TileBoxes, eps_sp, eps_t):
    """[nR, nC] bool: candidate tile can contain a match for the ref tile
    (the join's cylinder predicate lifted to bounding boxes)."""
    gx = _axis_gap(ref.xmin[:, None], ref.xmax[:, None],
                   cand.xmin[None, :], cand.xmax[None, :])
    gy = _axis_gap(ref.ymin[:, None], ref.ymax[:, None],
                   cand.ymin[None, :], cand.ymax[None, :])
    gt = _axis_gap(ref.tmin[:, None], ref.tmax[:, None],
                   cand.tmin[None, :], cand.tmax[None, :])
    eps_sp = _f32(eps_sp, gx)
    sp_ok = gx * gx + gy * gy <= eps_sp * eps_sp
    ok = sp_ok & (gt <= _f32(eps_t, gx))
    return ok & ref.nonempty[:, None] & cand.nonempty[None, :]


def coarse_pair_mask(spec: GridSpec, table: CellTable, ref: TileBoxes,
                     cand: TileBoxes, eps_sp, eps_t):
    """[nR, nC] bool coarse cell test (a conservative superset of exact):
    a candidate tile is kept when its center cell lies inside the ref
    tile's bbox expanded by ``eps`` plus the fleet-wide max candidate tile
    half-extent."""
    def half(lo, hi):
        ext = torch.where(cand.nonempty, hi - lo, 0.0)
        return 0.5 * ext.amax().clamp_min(0.0)

    half_x = half(cand.xmin, cand.xmax)
    half_y = half(cand.ymin, cand.ymax)
    half_t = half(cand.tmin, cand.tmax)

    def rng(lo, hi, pad, origin, cell, n):
        return (_cell_index(lo - pad, origin, cell, n),
                _cell_index(hi + pad, origin, cell, n))

    eps_sp = _f32(eps_sp, half_x)
    eps_t = _f32(eps_t, half_x)
    xlo, xhi = rng(ref.xmin, ref.xmax, eps_sp + half_x,
                   spec.x0, spec.cell_sp, spec.nx)
    ylo, yhi = rng(ref.ymin, ref.ymax, eps_sp + half_y,
                   spec.y0, spec.cell_sp, spec.ny)
    tlo, thi = rng(ref.tmin, ref.tmax, eps_t + half_t,
                   spec.t0, spec.cell_t, spec.nt)

    cc = table.coords                              # [nC, 3]
    inx = (cc[None, :, 0] >= xlo[:, None]) & (cc[None, :, 0] <= xhi[:, None])
    iny = (cc[None, :, 1] >= ylo[:, None]) & (cc[None, :, 1] <= yhi[:, None])
    int_ = (cc[None, :, 2] >= tlo[:, None]) & (cc[None, :, 2] <= thi[:, None])
    return inx & iny & int_ & ref.nonempty[:, None] & cand.nonempty[None, :]


def candidate_tile_mask(spec: GridSpec, table: CellTable, ref: TileBoxes,
                        cand: TileBoxes, eps_sp, eps_t):
    """Coarse cell test refined by the exact eps-expanded bbox test."""
    coarse = coarse_pair_mask(spec, table, ref, cand, eps_sp, eps_t)
    return coarse & exact_pair_mask(ref, cand, eps_sp, eps_t)


def compact_candidates(mask: torch.Tensor, max_tiles: int):
    """[nR, nC] bool -> (tile_ids [nR, max_tiles] int32 -1-padded, counts).

    Surviving tile ids in ascending order (the dense kernels' iteration
    order).  Ids beyond ``max_tiles`` are dropped: callers that need
    exactness size ``max_tiles >= counts.max()`` (``plan_max_tiles``).
    """
    nR, nC = mask.shape
    dev = mask.device
    idx = torch.arange(nC, dtype=torch.int32, device=dev)
    key = torch.where(mask, idx, nC + idx)        # survivors first, in order
    order = torch.argsort(key, dim=1, stable=True)[:, :max_tiles]
    if order.shape[1] < max_tiles:
        order = torch.nn.functional.pad(order, (0, max_tiles - nC), value=-1)
    counts = mask.sum(dim=1).to(torch.int32)
    slot = torch.arange(max_tiles, dtype=torch.int32, device=dev)[None, :]
    tile_ids = torch.where(slot < counts[:, None], order.to(torch.int32), -1)
    return tile_ids, counts


def plan_max_tiles(counts, *, multiple_of: int = 1) -> int:
    """Host-side: smallest static K (>= 1) covering every ref tile's list."""
    k = int(np.max(torch.as_tensor(counts).cpu().numpy(), initial=0))
    k = max(k, 1)
    return -(-k // multiple_of) * multiple_of


def prune_stats(counts: torch.Tensor, n_cand_tiles: int) -> PruneStats:
    n_ref = counts.shape[0]
    return PruneStats(
        kept_tiles=counts.sum().to(torch.int32),
        dense_tiles=int(n_ref * n_cand_tiles),
        max_per_ref=(counts.amax() if n_ref else counts.new_zeros(())
                     ).to(torch.int32))


# --------------------------------------------------------------------------
# row-level (per-trajectory) masks for the plain path
# --------------------------------------------------------------------------

def trajectory_pair_mask(ref_x, ref_y, ref_t, ref_valid,
                         cand_x, cand_y, cand_t, cand_valid,
                         eps_sp, eps_t):
    """[T, C] bool: candidate row can match some point of ref row (the
    tiles are whole trajectory rows; used by the plain join of
    ``core.geometry``)."""
    rb = _masked_boxes(ref_x, ref_y, ref_t, ref_valid)
    cb = _masked_boxes(cand_x, cand_y, cand_t, cand_valid)
    return exact_pair_mask(rb, cb, eps_sp, eps_t)
