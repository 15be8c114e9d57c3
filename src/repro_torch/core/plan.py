"""EnginePlan: the configuration surface of the port's ``run_dsc``.

The port's copy of ``repro.core.plan`` (pure Python, no JAX), cut to the
fields the port reads:

====================  =====================================================
stage                 plan fields
====================  =====================================================
join (Problem 1)      ``mode``, ``use_kernel``, ``use_index``
segmentation (P2)     ``seg_use_kernel`` (the CUDA Jaccard kernel)
similarity (SP)       ``sim_mode``
clustering (P3)       ``cluster_engine``, ``cluster_use_kernel``
====================  =====================================================

The port runs both modes (``"materialize"``, ``"fused"``) with
``sim_mode="dense"`` and no index; the other values validate here and
``run_dsc`` rejects them until they are ported.  ``use_kernel`` picks the
join kernel of materialize mode only: fused mode on the card always runs
its two kernels.  The reference's tile, top-K and distributed fields come
with the code that reads them; the fused tile geometry
(``fused_rows/bc/bm``) has no counterpart, since the CUDA kernels take no
tile geometry.
"""
from __future__ import annotations

import dataclasses

_MODES = ("materialize", "fused")
_ENGINES = ("rounds", "sequential")
_SIM_MODES = ("dense", "topk")


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """One per-stage engine configuration for the whole DSC pipeline."""

    mode: str = "materialize"          # "materialize" | "fused"
    use_kernel: bool = False           # CUDA join kernel (materialize only)
    use_index: bool = False            # grid candidate-tile pruning
    seg_use_kernel: bool = False       # CUDA TSA2 Jaccard kernel
    sim_mode: str = "dense"            # "dense" | "topk"
    cluster_engine: str = "rounds"     # "rounds" | "sequential"
    cluster_use_kernel: bool = False   # CUDA round-scan/claim-max kernels

    def validate(self) -> "EnginePlan":
        """Raise ``ValueError`` on an unknown engine; return ``self``.

        The messages are the reference's, word for word.
        """
        if self.mode not in _MODES:
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.cluster_engine not in _ENGINES:
            raise ValueError(f"unknown cluster engine {self.cluster_engine!r}")
        if self.sim_mode not in _SIM_MODES:
            raise ValueError(f"unknown sim_mode {self.sim_mode!r}")
        return self


def resolve_plan(plan: EnginePlan | None = None) -> EnginePlan:
    """The plan a run uses: ``plan`` validated, or the default plan."""
    return (EnginePlan() if plan is None else plan).validate()
