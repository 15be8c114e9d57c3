"""Production meshes (the port of ``repro.launch.mesh``).

Each function returns a :class:`~repro_torch.distributed.mesh.Mesh`
description with the reference's shape and axis names, one card a rank
over ``comm="nccl"``; nothing starts until ``mesh.spawn`` runs it, which
needs that many cards (256 or 512 here).

  make_production_mesh(multi_pod=False)
      (16, 16) ('data', 'model')           one v5e-256 pod's layout
      (2, 16, 16) ('pod', 'data', 'model') two pods

  make_dsc_mesh(multi_pod=False)
      ('part', 'model') view of the same ranks for the DSC pipeline:
      'part' = temporal partitions (folded pod x data), 'model' =
      candidate-trajectory parallelism.
"""
from __future__ import annotations

from repro_torch.distributed.mesh import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, "nccl", "cuda", axes)


def make_dsc_mesh(*, multi_pod: bool = False, model: int = 16) -> Mesh:
    n_devices = 512 if multi_pod else 256
    return Mesh((n_devices // model, model), "nccl", "cuda",
                ("part", "model"))


def make_test_mesh(part: int = 4, model: int = 2) -> Mesh:
    """Small mesh for multi-device tests."""
    return Mesh((part, model), "nccl", "cuda", ("part", "model"))


def dp_axes_of(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)
