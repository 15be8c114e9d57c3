"""Synthetic trajectory generators (counterpart of ``repro.data.synthetic``).

The same numpy generators, draw for draw, so a seed gives bitwise the same
batch as the JAX package; only the container is a torch
``TrajectoryBatch``, placed on ``device`` (``None`` = the card).

``figure1_scenario`` — the paper's running example: six routes through a
common midpoint O.  ``crossing_scenario`` — figure-1 traffic plus brief
crossers and fringe riders of the A->O corridor.  ``ais_like`` —
lane-following maritime traffic in the style of the Brest AIS data.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import TrajectoryBatch, pack_trajectories

_POINTS = {
    "A": np.array([0.0, 1.0]),
    "B": np.array([0.0, -1.0]),
    "C": np.array([2.0, 1.0]),
    "D": np.array([2.0, -1.0]),
    "O": np.array([1.0, 0.0]),
}
_ROUTES = [("A", "B"), ("A", "C"), ("A", "D"), ("B", "A"), ("B", "C"),
           ("B", "D")]
ROUTE_ENDPOINTS = list(_ROUTES)


def route_origins_dests(labels):
    """Per-trajectory (origin, destination) names for figure-1 labels."""
    origins = np.asarray([ROUTE_ENDPOINTS[r][0] for r in labels])
    dests = np.asarray([ROUTE_ENDPOINTS[r][1] for r in labels])
    return origins, dests


def _leg(p0, p1, n, t0, dt, rng, jitter):
    ts = np.linspace(0.0, 1.0, n, endpoint=False)
    pts = p0[None, :] + ts[:, None] * (p1 - p0)[None, :]
    pts = pts + rng.normal(0.0, jitter, pts.shape)
    t = t0 + np.arange(n) * dt
    return np.concatenate([pts, t[:, None]], axis=1)


def _figure1_trajs(n_per_route, points_per_leg, jitter, dt, time_jitter,
                   seed):
    rng = np.random.default_rng(seed)
    trajs, labels = [], []
    for ridx, (a, b) in enumerate(_ROUTES):
        for _ in range(n_per_route):
            t0 = rng.uniform(0.0, time_jitter * dt)
            leg1 = _leg(_POINTS[a], _POINTS["O"], points_per_leg, t0, dt,
                        rng, jitter)
            leg2 = _leg(_POINTS["O"], _POINTS[b], points_per_leg,
                        t0 + points_per_leg * dt, dt, rng, jitter)
            trajs.append(np.concatenate([leg1, leg2], axis=0))
            labels.append(ridx)
    return trajs, np.asarray(labels)


def figure1_scenario(n_per_route: int = 5, points_per_leg: int = 32,
                     jitter: float = 0.01, dt: float = 1.0,
                     time_jitter: float = 0.2, seed: int = 0,
                     pad_trajs_to: int | None = None, device=None):
    """Returns (batch, route_label[T]) — route label indexes ``_ROUTES``."""
    trajs, labels = _figure1_trajs(n_per_route, points_per_leg, jitter, dt,
                                   time_jitter, seed)
    batch = TrajectoryBatch.from_numpy(
        trajs, max_points=2 * points_per_leg, pad_trajs_to=pad_trajs_to,
        device=device)
    return batch, labels


def crossing_scenario(n_per_route: int = 3, points_per_leg: int = 16,
                      n_crossers: int = 4, n_fringe: int = 3,
                      fringe_offset: float = 0.32, seed: int = 2,
                      device=None):
    """Figure-1 traffic plus weak associates of the A->O corridor:
    crossers (share it briefly, then veer off) and fringe riders (parallel
    at about 0.75 * eps_sp).  Returns (batch, label, is_extra)."""
    rng = np.random.default_rng(seed)
    trajs, labels = _figure1_trajs(n_per_route, points_per_leg, 0.01, 1.0,
                                   0.2, seed)
    x, y, t, v, _ = pack_trajectories(trajs, max_points=2 * points_per_leg)
    T = x.shape[0]
    base = [np.stack([x[r][v[r]], y[r][v[r]], t[r][v[r]]], 1)
            for r in range(T)]
    mid = 0.5 * (_POINTS["A"] + _POINTS["O"])
    direction = (_POINTS["O"] - _POINTS["A"])
    direction = direction / np.linalg.norm(direction)
    normal = np.array([-direction[1], direction[0]])
    touch = max(3, points_per_leg // 4)
    extra_trajs = []
    for _ in range(n_crossers):
        t0 = 0.3 * points_per_leg + rng.uniform(0, 2.0)
        n = points_per_leg
        pts = np.zeros((n, 3))
        for i in range(n):
            if i < touch:
                pos = mid + direction * (i * 0.06) + rng.normal(0, 0.01, 2)
            else:
                pos = (mid + direction * (touch * 0.06)
                       + normal * ((i - touch) * 0.25)
                       + rng.normal(0, 0.01, 2))
            pts[i] = [pos[0], pos[1], t0 + i]
        extra_trajs.append(pts)
    for _ in range(n_fringe):
        t0 = rng.uniform(0, 1.0)
        n = points_per_leg
        off = fringe_offset * (1.0 + 0.1 * rng.standard_normal())
        pts = np.zeros((n, 3))
        seg = (_POINTS["O"] - _POINTS["A"])
        for i in range(n):
            pos = (_POINTS["A"] + seg * (i / n) + normal * off
                   + rng.normal(0, 0.005, 2))
            pts[i] = [pos[0], pos[1], t0 + i]
        extra_trajs.append(pts)
    out = TrajectoryBatch.from_numpy(base + extra_trajs,
                                     max_points=2 * points_per_leg,
                                     device=device)
    n_extra = n_crossers + n_fringe
    extra = np.concatenate([np.zeros(T, bool), np.ones(n_extra, bool)])
    return out, np.concatenate([labels, -np.ones(n_extra, int)]), extra


def ais_like(n_vessels: int = 64, n_lanes: int = 4, max_points: int = 128,
             area: float = 100.0, mean_speed: float = 0.4,
             sample_dt: float = 60.0, dt_jitter: float = 0.3,
             lane_width: float = 0.5, seed: int = 0,
             duration: float | None = None,
             pad_trajs_to: int | None = None, device=None):
    """Lane-following maritime-style traffic; returns (batch, lane_label)."""
    rng = np.random.default_rng(seed)
    lanes = rng.uniform(0.1 * area, 0.9 * area, (n_lanes, 2, 2))
    trajs, labels = [], []
    for _ in range(n_vessels):
        lane = int(rng.integers(n_lanes))
        p0, p1 = lanes[lane]
        direction = (p1 - p0) / (np.linalg.norm(p1 - p0) + 1e-9)
        offset = rng.normal(0.0, lane_width, 2)
        speed = mean_speed * rng.uniform(0.7, 1.3)
        n = int(rng.integers(max_points // 2, max_points + 1))
        t0 = rng.uniform(0.0, 0.25 * (duration or n * sample_dt))
        dts = sample_dt * rng.uniform(1.0 - dt_jitter, 1.0 + dt_jitter, n)
        t = t0 + np.cumsum(dts)
        s = speed * (t - t[0])
        s = np.minimum(s, np.linalg.norm(p1 - p0))
        pts = p0[None, :] + offset[None, :] + s[:, None] * direction[None, :]
        pts = pts + rng.normal(0.0, 0.05 * lane_width, pts.shape)
        trajs.append(np.concatenate([pts, t[:, None]], axis=1))
        labels.append(lane)
    batch = TrajectoryBatch.from_numpy(
        trajs, max_points=max_points, pad_trajs_to=pad_trajs_to,
        device=device)
    return batch, np.asarray(labels)


def default_dsc_params_for(batch: TrajectoryBatch):
    """Paper Sec. 6.1 heuristics: ``(diameter, mean sampling interval)``;
    eps_sp is taken as a share of the diameter, eps_t / delta_t as
    multiples of the interval."""
    v = batch.valid.cpu().numpy()
    x = batch.x.cpu().numpy()[v]
    y = batch.y.cpu().numpy()[v]
    t = batch.t.cpu().numpy()
    diam = float(np.hypot(x.max() - x.min(), y.max() - y.min()))
    dts = []
    for r in range(t.shape[0]):
        tr = t[r][v[r]]
        if len(tr) > 1:
            dts.append(np.diff(tr).mean())
    mean_dt = float(np.mean(dts)) if dts else 1.0
    return diam, mean_dt
