"""Synthetic trajectory generators (counterpart of ``repro.data.synthetic``).

The same numpy generators, draw for draw, so a seed gives bitwise the same
batch as the JAX package; only the container is a torch
``TrajectoryBatch``, placed on ``device`` (``None`` = the card).

``stream_records`` replays a batch as the streaming service's submission
batches; ``dirtify`` corrupts such a sequence with a known count of dirt.

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


def stream_records(batch: TrajectoryBatch, batch_size: int = 64,
                   order: str = "time"):
    """Replay a :class:`TrajectoryBatch` as a sequence of submission
    batches for the streaming service (``repro_torch.stream``).

    Flattens every valid point to a ``(obj, x, y, t)`` record, orders
    the stream (``"time"``: global event-time order, the realistic feed;
    ``"traj"``: row-major, worst case for the watermark), and yields
    :class:`~repro_torch.stream.ingest.Records` chunks of ``batch_size``.
    Deterministic — the same batch yields the same submission sequence,
    which is what lets a resumed service replay by absolute batch index.
    """
    from repro_torch.stream.ingest import Records
    x = batch.x.cpu().numpy()
    y = batch.y.cpu().numpy()
    t = batch.t.cpu().numpy()
    v = batch.valid.cpu().numpy()
    ids = batch.traj_id.cpu().numpy()
    rows, cols = np.nonzero(v)
    obj = ids[rows]
    keep = obj >= 0
    rows, cols, obj = rows[keep], cols[keep], obj[keep]
    if order == "time":
        srt = np.lexsort((obj, t[rows, cols]))
    elif order == "traj":
        srt = np.lexsort((t[rows, cols], obj))
    else:
        raise ValueError(f"order={order!r}: expected 'time' or 'traj'")
    rows, cols, obj = rows[srt], cols[srt], obj[srt]
    out = []
    for i in range(0, len(obj), batch_size):
        s = slice(i, i + batch_size)
        out.append(Records.build(obj[s], x[rows[s], cols[s]],
                                 y[rows[s], cols[s]], t[rows[s], cols[s]]))
    return out


def dirtify(recs_list, *, dup_frac: float = 0.0, nan_frac: float = 0.0,
            swap_frac: float = 0.0, teleport_frac: float = 0.0,
            teleport_dist: float = 50.0, seed: int = 0):
    """Seeded corruptor for a submission sequence — the chaos suite's
    ground truth generator.

    Takes the output of :func:`stream_records` and injects, per batch:

    * ``dup_frac``      — duplicated records (appended verbatim);
    * ``nan_frac``      — records with NaN coordinates;
    * ``swap_frac``     — adjacent same-object timestamp *swaps* (the
      mechanically-repairable dirt ``on_dirty="repair"`` fixes);
    * ``teleport_frac`` — records displaced ``teleport_dist`` away (GPS
      jumps the ``max_speed`` gate quarantines).

    Returns ``(dirty_list, truth)`` where ``truth`` counts exactly what
    was injected — tests assert the ingest counters against it.  Fully
    deterministic in ``seed``.
    """
    from repro_torch.stream.ingest import Records, concat_records
    rng = np.random.default_rng(seed)
    truth = {"dup": 0, "nan": 0, "swap_pairs": 0, "teleport": 0}
    out = []
    seen_objs: set = set()   # teleports need a baseline fix to be seen
    for recs in recs_list:
        obj = recs.obj.copy()
        x = recs.x.copy()
        y = recs.y.copy()
        t = recs.t.copy()
        n = recs.n
        if n and swap_frac > 0:
            # swap timestamps of adjacent same-object record pairs
            cand = np.nonzero(obj[:-1] == obj[1:])[0]
            take = cand[rng.random(cand.size) < swap_frac]
            used = np.zeros(n, bool)
            for i in take:
                if used[i] or used[i + 1] or t[i] == t[i + 1]:
                    continue
                t[i], t[i + 1] = t[i + 1], t[i]
                used[i] = used[i + 1] = True
                truth["swap_pairs"] += 1
        hit = np.zeros(n, bool)     # nan/teleport stay disjoint so the
        if n and teleport_frac > 0:  # truth counts match ingest's counters
            # never displace an object's first-ever record: the speed
            # gate has no baseline fix there, so such a jump would be
            # invisible to ingest and the truth count would overshoot
            eligible = np.zeros(n, bool)
            batch_seen = set(seen_objs)
            for i in range(n):
                o = int(obj[i])
                eligible[i] = o in batch_seen
                batch_seen.add(o)
            take = np.nonzero(
                (rng.random(n) < teleport_frac) & ~hit & eligible)[0]
            x[take] += teleport_dist
            hit[take] = True
            truth["teleport"] += int(take.size)
        if n and nan_frac > 0:
            take = np.nonzero((rng.random(n) < nan_frac) & ~hit)[0]
            x[take] = np.nan
            hit[take] = True
            truth["nan"] += int(take.size)
        dirty = Records(obj, x, y, t)
        if n and dup_frac > 0:
            take = np.nonzero(rng.random(n) < dup_frac)[0]
            if take.size:
                dirty = concat_records(
                    [dirty, Records(obj[take], x[take], y[take], t[take])])
                truth["dup"] += int(take.size)
        seen_objs.update(int(o) for o in obj)
        out.append(dirty)
    return out, truth


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
