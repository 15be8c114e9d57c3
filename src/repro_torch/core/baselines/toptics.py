"""T-OPTICS (Nanni & Pedreschi, 2006) — whole-trajectory clustering baseline.

OPTICS over a trajectory distance: the time-focused mean Euclidean distance
between trajectories over their common temporal span (the paper's Fig. 6
contrast: T-OPTICS recovers the six origin-destination *routes*, never the
shared subtrajectory structure).

(Counterpart of ``repro.core.baselines.toptics``: it reads the port's
``TrajectoryBatch`` on any device, on the host.)
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import TrajectoryBatch


def trajectory_distance(batch: TrajectoryBatch) -> np.ndarray:
    """[T, T] mean aligned Euclidean distance over the common time span."""
    x = batch.x.cpu().numpy()
    y = batch.y.cpu().numpy()
    t = batch.t.cpu().numpy()
    v = batch.valid.cpu().numpy()
    T = x.shape[0]
    D = np.full((T, T), np.inf)
    grids = []
    for r in range(T):
        tr = t[r][v[r]]
        grids.append((tr, x[r][v[r]], y[r][v[r]]))
    for i in range(T):
        ti, xi, yi = grids[i]
        if len(ti) < 2:
            continue
        D[i, i] = 0.0
        for j in range(i + 1, T):
            tj, xj, yj = grids[j]
            if len(tj) < 2:
                continue
            lo, hi = max(ti[0], tj[0]), min(ti[-1], tj[-1])
            if hi <= lo:
                continue
            grid = np.linspace(lo, hi, 32)
            xi_g = np.interp(grid, ti, xi)
            yi_g = np.interp(grid, ti, yi)
            xj_g = np.interp(grid, tj, xj)
            yj_g = np.interp(grid, tj, yj)
            D[i, j] = D[j, i] = float(
                np.mean(np.hypot(xi_g - xj_g, yi_g - yj_g)))
    return D


def optics(D: np.ndarray, eps: float, min_pts: int):
    """Classic OPTICS ordering + reachability; returns (order, reach)."""
    n = D.shape[0]
    reach = np.full(n, np.inf)
    processed = np.zeros(n, bool)
    order = []

    def core_distance(p):
        d = np.sort(D[p][D[p] <= eps])
        return d[min_pts - 1] if len(d) >= min_pts else np.inf

    for p0 in range(n):
        if processed[p0]:
            continue
        seeds: dict[int, float] = {p0: np.inf}
        while seeds:
            p = min(seeds, key=seeds.get)
            del seeds[p]
            if processed[p]:
                continue
            processed[p] = True
            order.append(p)
            cd = core_distance(p)
            if np.isfinite(cd):
                for q in np.nonzero(D[p] <= eps)[0]:
                    if processed[q]:
                        continue
                    nr = max(cd, D[p, q])
                    if nr < reach[q]:
                        reach[q] = nr
                        seeds[q] = nr
    return np.asarray(order), reach


def extract_clusters(order: np.ndarray, reach: np.ndarray,
                     xi_eps: float) -> np.ndarray:
    """DBSCAN-style extraction: split ordering where reachability > xi_eps."""
    labels = np.full(len(order), -1)
    cid = -1
    fresh = True
    for idx, p in enumerate(order):
        if reach[p] > xi_eps:
            fresh = True
            continue
        if fresh:
            cid += 1
            fresh = False
            if idx > 0:
                labels[order[idx - 1]] = cid   # the core that opened it
        labels[p] = cid
    return labels


def t_optics(batch: TrajectoryBatch, eps: float, min_pts: int,
             xi_eps: float | None = None):
    D = trajectory_distance(batch)
    finite = D[np.isfinite(D) & (D > 0)]
    if xi_eps is None:
        xi_eps = float(np.percentile(finite, 25)) if len(finite) else eps
    order, reach = optics(D, eps, min_pts)
    labels = extract_clusters(order, reach, xi_eps)
    return {"labels": labels, "order": order, "reach": reach, "D": D}
