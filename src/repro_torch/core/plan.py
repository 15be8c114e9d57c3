"""EnginePlan: the configuration surface of the port's ``run_dsc``.

The port's copy of ``repro.core.plan`` (pure Python, no JAX), cut to the
fields the port reads:

====================  =====================================================
stage                 plan fields
====================  =====================================================
join (Problem 1)      ``mode``, ``use_kernel``, ``use_index``
segmentation (P2)     ``seg_use_kernel`` (the CUDA Jaccard kernel)
similarity (SP)       ``sim_mode``, ``sim_topk`` (K), ``sim_panel`` (Sb)
clustering (P3)       ``cluster_engine``, ``cluster_use_kernel``
====================  =====================================================

The port runs both modes (``"materialize"``, ``"fused"``) with either
similarity representation (``"dense"``, ``"topk"``) and no index;
``use_index`` validates here and ``run_dsc`` rejects it until it is
ported.  ``use_kernel`` picks the join kernel of materialize mode only:
fused mode on the card always runs its kernels.  ``sim_topk=None`` means
K = 32 and ``sim_panel=None`` a panel height of at most 128, both resolved
at run time against S.  The reference's tile and distributed fields come
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
    sim_topk: int | None = None        # K of the top-K lists (None = 32)
    sim_panel: int | None = None       # panel height Sb (None = 128-snap)
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
        for name in ("sim_topk", "sim_panel"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v < 1):
                raise ValueError(f"{name} must be None or a positive int, "
                                 f"got {v!r}")
        return self


def resolve_plan(plan: EnginePlan | None = None) -> EnginePlan:
    """The plan a run uses: ``plan`` validated, or the default plan."""
    return (EnginePlan() if plan is None else plan).validate()
