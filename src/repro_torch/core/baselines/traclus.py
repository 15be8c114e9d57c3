"""TraClus (Lee, Han, Whang; SIGMOD 2007) — partition-and-group baseline.

Faithful NumPy implementation of the three phases:
  1. MDL-based trajectory partitioning into directed segments (time ignored —
     TraClus is a 2D algorithm, which is exactly the contrast the paper draws);
  2. density-based clustering of segments (DBSCAN with the 3-component
     segment distance: perpendicular + parallel + angular);
  3. representative trajectory per cluster (average sweep).

(Counterpart of ``repro.core.baselines.traclus``: it reads the port's
``TrajectoryBatch`` on any device, on the host.)
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import TrajectoryBatch


# ------------------------- segment distance --------------------------------

def _seg_dist(si: np.ndarray, sj: np.ndarray) -> float:
    """Lee et al. distance between directed segments si=(s,e), sj=(s,e)."""
    (s1, e1), (s2, e2) = si, sj
    l1 = np.linalg.norm(e1 - s1)
    l2 = np.linalg.norm(e2 - s2)
    if l1 < l2:                       # Li must be the longer one
        (s1, e1, l1), (s2, e2, l2) = (s2, e2, l2), (s1, e1, l1)
    d = e1 - s1
    denom = max(l1 * l1, 1e-12)

    def proj(p):
        u = np.dot(p - s1, d) / denom
        return u, s1 + u * d

    u_s, ps = proj(s2)
    u_e, pe = proj(e2)
    l_perp1 = np.linalg.norm(s2 - ps)
    l_perp2 = np.linalg.norm(e2 - pe)
    d_perp = ((l_perp1 ** 2 + l_perp2 ** 2) / (l_perp1 + l_perp2)
              if (l_perp1 + l_perp2) > 1e-12 else 0.0)

    l_par1 = min(abs(u_s) * l1, abs(u_s - 1.0) * l1)
    l_par2 = min(abs(u_e) * l1, abs(u_e - 1.0) * l1)
    d_par = min(l_par1, l_par2)

    cos_t = np.dot(d, e2 - s2) / max(l1 * l2, 1e-12)
    cos_t = np.clip(cos_t, -1.0, 1.0)
    sin_t = np.sqrt(1.0 - cos_t * cos_t)
    d_ang = l2 * sin_t if cos_t >= 0 else l2
    return d_perp + d_par + d_ang


# ------------------------- MDL partitioning --------------------------------

def _mdl_partition(pts: np.ndarray) -> list[int]:
    """Characteristic point indices via the approximate MDL sweep."""
    n = len(pts)
    if n < 3:
        return list(range(n))
    cps = [0]
    start, length = 0, 1
    while start + length < n:
        curr = start + length
        # cost of replacing pts[start..curr] with one segment
        seg = (pts[start], pts[curr])
        l_h = np.log2(max(np.linalg.norm(pts[curr] - pts[start]), 1e-12) + 1)
        dsum_perp, dsum_ang = 0.0, 0.0
        for k in range(start, curr):
            sub = (pts[k], pts[k + 1])
            dsum_perp += _perp_only(seg, sub)
            dsum_ang += _ang_only(seg, sub)
        l_dh = np.log2(dsum_perp + 1) + np.log2(dsum_ang + 1)
        cost_par = l_h + l_dh
        cost_nopar = sum(
            np.log2(max(np.linalg.norm(pts[k + 1] - pts[k]), 1e-12) + 1)
            for k in range(start, curr))
        if cost_par > cost_nopar:
            cps.append(curr - 1 if curr - 1 > start else curr)
            start = cps[-1]
            length = 1
        else:
            length += 1
    cps.append(n - 1)
    return sorted(set(cps))


def _perp_only(seg, sub) -> float:
    (s1, e1), (s2, e2) = seg, sub
    d = e1 - s1
    denom = max(np.dot(d, d), 1e-12)

    def dist(p):
        u = np.dot(p - s1, d) / denom
        return np.linalg.norm(p - (s1 + u * d))

    l1, l2 = dist(s2), dist(e2)
    return (l1 ** 2 + l2 ** 2) / (l1 + l2) if (l1 + l2) > 1e-12 else 0.0


def _ang_only(seg, sub) -> float:
    (s1, e1), (s2, e2) = seg, sub
    l1 = max(np.linalg.norm(e1 - s1), 1e-12)
    l2 = np.linalg.norm(e2 - s2)
    cos_t = np.clip(np.dot(e1 - s1, e2 - s2) / max(l1 * l2, 1e-12), -1, 1)
    return l2 * np.sqrt(1 - cos_t ** 2)


# ------------------------- main entry ---------------------------------------

def traclus(batch: TrajectoryBatch, eps: float, min_lns: int):
    """Returns dict with segments, labels (-1 noise), representatives."""
    xs = batch.x.cpu().numpy()
    ys = batch.y.cpu().numpy()
    vs = batch.valid.cpu().numpy()
    segments, seg_traj = [], []
    for r in range(xs.shape[0]):
        pts = np.stack([xs[r][vs[r]], ys[r][vs[r]]], axis=1)
        if len(pts) < 2:
            continue
        cps = _mdl_partition(pts)
        for a, b in zip(cps[:-1], cps[1:]):
            if b > a:
                segments.append((pts[a], pts[b]))
            seg_traj.append(r)
    n = len(segments)
    if n == 0:
        return {"segments": [], "labels": np.array([]), "reps": []}

    # pairwise distance matrix (n is small for baseline-scale data)
    D = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            D[i, j] = D[j, i] = _seg_dist(
                np.stack(segments[i]), np.stack(segments[j]))

    # DBSCAN over segments
    labels = np.full(n, -1)
    cid = 0
    visited = np.zeros(n, bool)
    for i in range(n):
        if visited[i]:
            continue
        visited[i] = True
        nbrs = list(np.nonzero(D[i] <= eps)[0])
        if len(nbrs) < min_lns:
            continue
        labels[i] = cid
        queue = [j for j in nbrs if j != i]
        while queue:
            j = queue.pop()
            if labels[j] == -1:
                labels[j] = cid
            if not visited[j]:
                visited[j] = True
                nbrs_j = np.nonzero(D[j] <= eps)[0]
                if len(nbrs_j) >= min_lns:
                    queue.extend(k for k in nbrs_j if labels[k] == -1)
        cid += 1

    reps = []
    for c in range(cid):
        segs = [segments[i] for i in np.nonzero(labels == c)[0]]
        reps.append(_representative(segs, min_lns))
    return {"segments": segments, "labels": labels, "reps": reps,
            "seg_traj": np.asarray(seg_traj[:n])}


def _representative(segs, min_lns: int) -> np.ndarray:
    """Average-sweep representative of a set of segments."""
    vecs = np.stack([e - s for s, e in segs])
    mean_v = vecs.mean(axis=0)
    nrm = np.linalg.norm(mean_v)
    ax = mean_v / nrm if nrm > 1e-12 else np.array([1.0, 0.0])
    rot = np.array([[ax[0], ax[1]], [-ax[1], ax[0]]])
    ends = np.stack([np.stack([rot @ s, rot @ e]) for s, e in segs])
    xs = np.sort(ends[..., 0].ravel())
    pts = []
    for xv in xs:
        ys = []
        for (p, q) in ends:
            x0, x1 = sorted([p[0], q[0]])
            if x0 - 1e-9 <= xv <= x1 + 1e-9 and x1 - x0 > 1e-12:
                tpar = (xv - p[0]) / (q[0] - p[0])
                ys.append(p[1] + tpar * (q[1] - p[1]))
        if len(ys) >= max(min_lns, 2):
            pts.append([xv, float(np.mean(ys))])
    if not pts:
        mid = np.stack([0.5 * (s + e) for s, e in segs]).mean(axis=0)
        return mid[None, :]
    return (np.linalg.inv(rot) @ np.asarray(pts).T).T
