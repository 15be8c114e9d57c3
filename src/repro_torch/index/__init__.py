"""Spatiotemporal candidate-pruning index for the subtrajectory join
(counterpart of ``repro.index``).

``grid`` -- fixed-resolution (eps-derived) grid over tile bounding boxes:
CSR cell tables, conservative candidate-tile masks, compacted tile lists.
"""
from repro_torch.index.grid import (
    CellTable,
    GridSpec,
    PruneStats,
    TileBoxes,
    build_cell_table,
    candidate_tile_mask,
    coarse_pair_mask,
    compact_candidates,
    exact_pair_mask,
    fit_grid,
    plan_max_tiles,
    point_block_boxes,
    prune_stats,
    traj_block_boxes,
    trajectory_pair_mask,
)

__all__ = [
    "CellTable",
    "GridSpec",
    "PruneStats",
    "TileBoxes",
    "build_cell_table",
    "candidate_tile_mask",
    "coarse_pair_mask",
    "compact_candidates",
    "exact_pair_mask",
    "fit_grid",
    "plan_max_tiles",
    "point_block_boxes",
    "prune_stats",
    "traj_block_boxes",
    "trajectory_pair_mask",
]
