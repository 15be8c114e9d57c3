"""The benchmark's data: AIS-like slices and their DSC parameters, in numpy.

A frozen copy of the port's launcher data (``ais_like`` with the launcher's
8 lanes, packed as ``pack_trajectories`` packs it) and of its parameter
rule (``default_dsc_params_for`` with the registry's scales), so that the
inputs of a cell stay what they are whatever the program does later.  The
program receives only the arrays and the parameters made here; the
reference is handed the same.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Slice:
    """One job's input: ``[T, M]`` arrays (rows time-sorted over a valid
    prefix) and the parameters that the config's rule gives them."""

    x: np.ndarray        # [T, M] float32
    y: np.ndarray        # [T, M] float32
    t: np.ndarray        # [T, M] float32
    valid: np.ndarray    # [T, M] bool
    traj_id: np.ndarray  # [T] int32
    params: dict         # DSCParams fields

    @property
    def shape(self) -> tuple[int, int]:
        return self.x.shape


def ais_like(n_vessels: int, n_lanes: int, max_points: int, seed: int,
             area: float = 100.0, mean_speed: float = 0.4,
             sample_dt: float = 60.0, dt_jitter: float = 0.3,
             lane_width: float = 0.5):
    """Lane-following maritime traffic, draw for draw the launcher's:
    ``(x, y, t, valid, traj_id)`` numpy arrays of ``[n_vessels,
    max_points]``."""
    rng = np.random.default_rng(seed)
    lanes = rng.uniform(0.1 * area, 0.9 * area, (n_lanes, 2, 2))
    trajs = []
    for _ in range(n_vessels):
        lane = int(rng.integers(n_lanes))
        p0, p1 = lanes[lane]
        direction = (p1 - p0) / (np.linalg.norm(p1 - p0) + 1e-9)
        offset = rng.normal(0.0, lane_width, 2)
        speed = mean_speed * rng.uniform(0.7, 1.3)
        n = int(rng.integers(max_points // 2, max_points + 1))
        t0 = rng.uniform(0.0, 0.25 * (n * sample_dt))
        dts = sample_dt * rng.uniform(1.0 - dt_jitter, 1.0 + dt_jitter, n)
        t = t0 + np.cumsum(dts)
        s = speed * (t - t[0])
        s = np.minimum(s, np.linalg.norm(p1 - p0))
        pts = p0[None, :] + offset[None, :] + s[:, None] * direction[None, :]
        pts = pts + rng.normal(0.0, 0.05 * lane_width, pts.shape)
        trajs.append(np.concatenate([pts, t[:, None]], axis=1))
    return pack(trajs, max_points)


def pack(trajs, max_points: int):
    """``[n_i, 3]`` (x, y, t) arrays -> padded ``(x, y, t, valid,
    traj_id)``, each row sorted by time (stable) and cut to
    ``max_points``."""
    T, M = len(trajs), max_points
    x = np.zeros((T, M), np.float32)
    y = np.zeros((T, M), np.float32)
    t = np.zeros((T, M), np.float32)
    valid = np.zeros((T, M), bool)
    ids = np.full((T,), -1, np.int32)
    for i, tr in enumerate(trajs):
        tr = np.asarray(tr, np.float32)
        tr = tr[np.argsort(tr[:, 2], kind="stable")][:M]
        m = len(tr)
        x[i, :m], y[i, :m], t[i, :m] = tr[:, 0], tr[:, 1], tr[:, 2]
        valid[i, :m] = True
        ids[i] = i
    return x, y, t, valid, ids


def diameter_and_interval(x, y, t, valid):
    """Paper Sec. 6.1 heuristics: ``(diameter, mean sampling interval)``."""
    xv, yv = x[valid], y[valid]
    diam = float(np.hypot(xv.max() - xv.min(), yv.max() - yv.min()))
    dts = [np.diff(t[r][valid[r]]).mean() for r in range(t.shape[0])
           if valid[r].sum() > 1]
    return diam, (float(np.mean(dts)) if dts else 1.0)


def params_for(config: dict, x, y, t, valid) -> dict:
    """The DSCParams fields of a slice under the config's rule:
    ``eps_sp`` a share of the diameter, ``eps_t`` a multiple of the mean
    sampling interval, the rest as the config states them."""
    rule = config["params"]
    diam, mean_dt = diameter_and_interval(x, y, t, valid)
    return dict(eps_sp=rule["eps_sp_diameter_share"] * diam,
                eps_t=rule["eps_t_intervals"] * mean_dt,
                delta_t=rule["delta_t"], w=rule["w"], tau=rule["tau"],
                alpha_sigma=rule["alpha_sigma"], k_sigma=rule["k_sigma"],
                alpha_abs=-1.0, k_abs=-1.0,
                max_subtrajs_per_traj=rule["max_subtrajs_per_traj"],
                segmentation=rule["segmentation"])


def make_slice(config: dict, seed: int) -> Slice:
    """One slice of the config's shape from ``seed``."""
    data = config["data"]
    if data["generator"] != "ais_like":
        raise ValueError(f"unknown generator {data['generator']!r}")
    x, y, t, valid, ids = ais_like(config["n_trajs"], data["n_lanes"],
                                   data["max_points"], seed)
    return Slice(x, y, t, valid, ids, params_for(config, x, y, t, valid))
