"""Shared evaluation metrics: RMSE (Sec. 6.2) and ground-truth scoring
(counterpart of ``repro.core.evaluation``, numpy on the host).

The RMSE used in the paper's Fig. 7 is "a measure of intra-cluster distance
between the representatives and the cluster members".  We compute it
geometrically and identically for every method: for each member *point*, the
distance to the nearest representative point (within the eps_t temporal
window when timestamps exist, spatial-nearest otherwise), RMS-aggregated.

Every function takes the port's ``TrajectoryBatch`` (on any device) and
numpy arrays or tensors; tensors are copied to the host where the
reference calls ``np.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import TrajectoryBatch


def _np(a) -> np.ndarray:
    """A host numpy array of ``a`` (a tensor on any device, or array-like)."""
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _slot_points(xyt: tuple, sub_local: np.ndarray, slot: int,
                 max_subs: int) -> np.ndarray:
    """``[n, 3]`` points of ``slot``; ``xyt`` the batch's host arrays."""
    r, k = divmod(slot, max_subs)
    sel = (sub_local[r] == k)
    return np.stack([a[r][sel] for a in xyt], axis=1)


def rmse_subtraj(batch: TrajectoryBatch, sub_local: np.ndarray,
                 member_of: np.ndarray, is_rep: np.ndarray,
                 max_subs: int, eps_t: float | None = None) -> float:
    """Point-level intra-cluster RMSE for subtrajectory clusterings."""
    sub_local, member_of, is_rep = map(_np, (sub_local, member_of, is_rep))
    xyt = (_np(batch.x), _np(batch.y), _np(batch.t))
    sq, n = 0.0, 0
    for s in range(len(member_of)):
        rep = member_of[s]
        if rep < 0 or is_rep[s] or rep == s:
            continue
        mp = _slot_points(xyt, sub_local, s, max_subs)
        rp = _slot_points(xyt, sub_local, int(rep), max_subs)
        if len(mp) == 0 or len(rp) == 0:
            continue
        d_sp = np.hypot(mp[:, None, 0] - rp[None, :, 0],
                        mp[:, None, 1] - rp[None, :, 1])
        if eps_t is not None:
            d_t = np.abs(mp[:, None, 2] - rp[None, :, 2])
            masked = np.where(d_t <= eps_t, d_sp, np.inf)
            best = np.min(masked, axis=1)
            best = np.where(np.isfinite(best), best, np.min(d_sp, axis=1))
        else:
            best = np.min(d_sp, axis=1)
        sq += float(np.sum(best ** 2))
        n += len(best)
    return float(np.sqrt(sq / n)) if n else 0.0


def rmse_sim_based(sim: np.ndarray, member_of: np.ndarray,
                   is_rep: np.ndarray, eps_sp: float) -> float:
    """The paper's RMSE ('equivalent to SSCR', Sec. 6.2): via Lemma 1 the
    mean member->representative distance is ``eps_sp * (1 - Sim)``; RMS over
    all cluster members.  Lower is better/tighter."""
    sim, member_of, is_rep = map(_np, (sim, member_of, is_rep))
    sq, n = 0.0, 0
    for s in range(len(member_of)):
        rep = member_of[s]
        if rep < 0 or is_rep[s]:
            continue
        d = eps_sp * (1.0 - float(np.clip(sim[s, rep], 0.0, 1.0)))
        sq += d * d
        n += 1
    return float(np.sqrt(sq / n)) if n else 0.0


def rmse_traclus(res: dict, eps_sp: float | None = None) -> float:
    """RMSE for TraClus: segment endpoints/midpoint vs representative
    polyline.  When ``eps_sp`` is given, distances are clipped at eps_sp so
    the value is on the same scale as ``rmse_sim_based``."""
    labels = res["labels"]
    sq, n = 0.0, 0
    for i, lab in enumerate(labels):
        if lab < 0 or lab >= len(res["reps"]):
            continue
        rep = res["reps"][lab]
        if rep is None or len(rep) == 0:
            continue
        s, e = res["segments"][i]
        for p in (s, 0.5 * (s + e), e):
            d = np.min(np.hypot(rep[:, 0] - p[0], rep[:, 1] - p[1]))
            if eps_sp is not None:
                d = min(d, eps_sp)
            sq += float(d ** 2)
            n += 1
    return float(np.sqrt(sq / n)) if n else 0.0


def leg_labels(batch: TrajectoryBatch, sub_local: np.ndarray,
               origin_of_traj: np.ndarray, dest_of_traj: np.ndarray,
               t_split: float, max_subs: int) -> dict[int, tuple[str, str]]:
    """Ground-truth label per subtraj slot for the figure-1 scenario.

    A subtrajectory mostly before the midpoint belongs to the *origin* leg
    (e.g. A->O, shared by all A-* routes); mostly after, to the
    *destination* leg (O->B etc.) — the clusters of Fig. 1(b)/Sec. 6.2.
    """
    t = _np(batch.t)
    v = _np(batch.valid)
    sub_local = _np(sub_local)
    out: dict[int, tuple[str, str]] = {}
    T = t.shape[0]
    for r in range(T):
        for k in range(max_subs):
            sel = (sub_local[r] == k) & v[r]
            if not sel.any():
                continue
            if t[r][sel].mean() < t_split:
                out[r * max_subs + k] = ("O", str(origin_of_traj[r]))
            else:
                out[r * max_subs + k] = ("D", str(dest_of_traj[r]))
    return out


def cluster_purity(assign: dict[int, int], truth: dict[int, tuple]) -> float:
    """Weighted purity of clusters w.r.t. ground-truth labels."""
    from collections import Counter, defaultdict
    groups = defaultdict(list)
    for s, c in assign.items():
        if s in truth:
            groups[c].append(truth[s])
    total, pure = 0, 0
    for _, labs in groups.items():
        total += len(labs)
        pure += Counter(labs).most_common(1)[0][1]
    return pure / total if total else 0.0


def pairwise_f1(assign: dict[int, int], truth: dict[int, tuple]) -> float:
    """Pair-counting F-measure between clustering and ground truth."""
    items = [s for s in assign if s in truth]
    tp = fp = fn = 0
    for i in range(len(items)):
        for j in range(i + 1, len(items)):
            a, b = items[i], items[j]
            same_c = assign[a] == assign[b]
            same_t = truth[a] == truth[b]
            tp += same_c and same_t
            fp += same_c and not same_t
            fn += same_t and not same_c
    prec = tp / (tp + fp) if tp + fp else 1.0
    rec = tp / (tp + fn) if tp + fn else 1.0
    return 2 * prec * rec / (prec + rec) if prec + rec else 0.0
