"""Core data model of the PyTorch port (counterpart of ``repro.core.types``).

Plain dataclasses holding tensors.  The canonical layout is
*trajectory-major*: a batch of ``T`` trajectories, each padded to ``M``
timestamped points; invalid slots carry ``valid == False`` and are ignored
by every operator.  Packed neighbor words travel as ``int32`` bit patterns
(PyTorch's ``uint32`` has no shifts on the CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import resolve_device


@dataclasses.dataclass(frozen=True)
class DSCParams:
    """All parameters of the DSC pipeline (paper Table 1).

    ``alpha``/``k`` are expressed in standard deviations around the mean
    of the similarity / voting distribution (``alpha_sigma``, ``k_sigma``)
    unless the absolute overrides are >= 0.
    """

    eps_sp: float = 0.1
    eps_t: float = 0.5
    delta_t: float = 0.0
    w: int = 10
    tau: float = 0.4
    alpha_sigma: float = 0.0
    k_sigma: float = 0.0
    alpha_abs: float = -1.0
    k_abs: float = -1.0
    max_subtrajs_per_traj: int = 8
    segmentation: str = "tsa1"   # "tsa1" | "tsa2"

    def replace(self, **kw) -> "DSCParams":
        return dataclasses.replace(self, **kw)


def f32(v, device) -> torch.Tensor:
    """A scalar parameter as a float32 tensor: every threshold is compared
    and multiplied in float32, as the JAX package does under ``jit``."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.  PyTorch's vectorized float32
    ``sqrt`` on the CPU can be an ulp off; the float64 root rounded to
    float32 is exact (53 >= 2 * 24 + 2 bits), on every backend, so the
    plain versions match IEEE ``sqrtf`` and the CUDA kernels bit for bit."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


@dataclasses.dataclass
class TrajectoryBatch:
    """``T`` trajectories padded to ``M`` points, time-sorted within a row."""

    x: torch.Tensor        # [T, M] float32
    y: torch.Tensor        # [T, M] float32
    t: torch.Tensor        # [T, M] float32 (seconds)
    valid: torch.Tensor    # [T, M] bool
    traj_id: torch.Tensor  # [T] int32 (-1 = padding row)

    @property
    def num_trajs(self) -> int:
        return self.x.shape[0]

    @property
    def max_points(self) -> int:
        return self.x.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=1).to(torch.int32)

    def to(self, device) -> "TrajectoryBatch":
        return TrajectoryBatch(*(getattr(self, f.name).to(device)
                                 for f in dataclasses.fields(self)))

    @staticmethod
    def from_arrays(x, y, t, valid, traj_id, device=None) -> "TrajectoryBatch":
        """Wrap ``[T, M]`` arrays (numpy or tensors) on ``device``
        (``None`` = the card)."""
        dev = resolve_device(device)
        as_t = lambda a, dt: torch.as_tensor(np.array(a), dtype=dt).to(dev)
        return TrajectoryBatch(
            x=as_t(x, torch.float32), y=as_t(y, torch.float32),
            t=as_t(t, torch.float32), valid=as_t(valid, torch.bool),
            traj_id=as_t(traj_id, torch.int32))

    @staticmethod
    def from_numpy(trajs: list[np.ndarray], max_points: int | None = None,
                   pad_trajs_to: int | None = None,
                   device=None) -> "TrajectoryBatch":
        """Build a batch from a list of ``[n_i, 3]`` (x, y, t) arrays."""
        return TrajectoryBatch.from_arrays(
            *pack_trajectories(trajs, max_points, pad_trajs_to),
            device=device)


def pack_trajectories(trajs, max_points=None, pad_trajs_to=None):
    """``[n_i, 3]`` arrays -> padded numpy ``(x, y, t, valid, traj_id)``,
    each row sorted by time (stable) and cut to ``max_points``."""
    n = len(trajs)
    T = pad_trajs_to or n
    M = max_points or max((len(tr) for tr in trajs), default=1)
    x = np.zeros((T, M), np.float32)
    y = np.zeros((T, M), np.float32)
    t = np.zeros((T, M), np.float32)
    valid = np.zeros((T, M), bool)
    ids = np.full((T,), -1, np.int32)
    for i, tr in enumerate(trajs):
        tr = np.asarray(tr, np.float32)
        order = np.argsort(tr[:, 2], kind="stable")
        tr = tr[order][:M]
        m = len(tr)
        x[i, :m], y[i, :m], t[i, :m] = tr[:, 0], tr[:, 1], tr[:, 2]
        valid[i, :m] = True
        ids[i] = i
    return x, y, t, valid, ids


@dataclasses.dataclass
class JoinResult:
    """Dense DTJ output: ``best_w`` / ``best_idx`` ``[T, M, C]`` (weight of
    the best match of ref point (r, m) in candidate c, 0 / -1 when none)."""

    best_w: torch.Tensor    # [T, M, C] float32
    best_idx: torch.Tensor  # [T, M, C] int32


@dataclasses.dataclass
class SubtrajSegmentation:
    """Output of TSA1/TSA2 (Problem 2)."""

    cut: torch.Tensor        # [T, M] bool
    sub_local: torch.Tensor  # [T, M] int32 (-1 on padding)
    num_subs: torch.Tensor   # [T] int32
    score: torch.Tensor      # [T, M] float32, the signal d[]


@dataclasses.dataclass
class SubtrajTable:
    """The ST relation: one row per (traj, local subtraj) slot."""

    t_start: torch.Tensor   # [S] float32
    t_end: torch.Tensor     # [S] float32
    voting: torch.Tensor    # [S] float32
    card: torch.Tensor      # [S] int32
    valid: torch.Tensor     # [S] bool
    traj_row: torch.Tensor  # [S] int32

    @property
    def num_slots(self) -> int:
        return self.t_start.shape[0]


@dataclasses.dataclass
class ClusteringResult:
    """Output of Algorithm 4: ``member_of[s] == s`` for representatives,
    ``>= 0`` for members, ``< 0`` for outliers (valid slots)."""

    member_of: torch.Tensor   # [S] int32
    member_sim: torch.Tensor  # [S] float32
    is_rep: torch.Tensor      # [S] bool
    is_outlier: torch.Tensor  # [S] bool
    alpha_used: torch.Tensor  # [] float32
    k_used: torch.Tensor      # [] float32


@dataclasses.dataclass
class TopKSim:
    """Sparse SP relation: per-row top-K neighbor lists of the symmetrized,
    Eq. 2-normalized similarity matrix, bounded to a width ``K`` instead
    of densified to ``[S, S]``.

    Rows are sorted by similarity descending, ties by ascending neighbor
    slot (``lax.top_k``'s order in the JAX package; the port gets it from
    a stable descending sort).  Entries beyond the row's positive degree
    carry ``ids == -1`` and ``sims == 0``.

    Exactness certificate: ``spill[s]`` is the (K+1)-th largest positive
    similarity of row ``s`` (0 when the row has at most K positive
    entries).  Every dropped entry is ``<= spill[s]``, so ``spill[s] <
    alpha`` proves the list holds every alpha-edge of ``s`` and the
    clustering engines are label-identical to the dense ones
    (``core.similarity.topk_overflow`` counts the rows where it fails).
    ``degree`` and the ``row_*`` moments are exact statistics of the full
    positive row, so alpha resolves as from the dense matrix.
    """

    ids: torch.Tensor         # [S, K] int32 neighbor slots (-1 padding)
    sims: torch.Tensor        # [S, K] float32, descending per row
    spill: torch.Tensor       # [S] float32 (K+1)-th largest positive sim
    degree: torch.Tensor      # [S] int32 positive entries of the full row
    row_sum: torch.Tensor     # [S] float32 sum of positive entries
    row_sumsq: torch.Tensor   # [S] float32 sum of squared positive entries

    @property
    def num_slots(self) -> int:
        return self.ids.shape[0]

    @property
    def k(self) -> int:
        return self.ids.shape[1]
