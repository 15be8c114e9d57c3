"""EnginePlan: the configuration surface of the port's ``run_dsc``.

The port's copy of ``repro.core.plan`` (pure Python, no JAX), with every
field of the reference, the same defaults, the same validation messages
and the same JSON form, so that a plan file written by either package
(``EnginePlan.save``, or the reference autotuner's plan store) loads in
the other with an equal ``to_dict``:

====================  =====================================================
stage                 plan fields
====================  =====================================================
join (Problem 1)      ``mode`` ("materialize" | "fused"), ``use_kernel``,
                      ``use_index``; TPU tile geometry ``fused_rows`` /
                      ``fused_bc`` / ``fused_bm``
segmentation (P2)     ``seg_use_kernel`` (the CUDA Jaccard kernel)
similarity (SP)       ``sim_mode`` ("dense" | "topk"), ``sim_topk`` (K),
                      ``sim_panel`` (Sb); distributed-only:
                      ``sim_strategy``, ``sim_dtype``, ``sim_exchange``
comm (distributed)    ``halo_stream``, ``sim_exchange``
clustering (P3)       ``cluster_engine`` ("rounds" | "sequential"),
                      ``cluster_use_kernel``; TPU tile geometry
                      ``cluster_bu`` / ``cluster_bs``
====================  =====================================================

The single-device paths read neither of two groups of fields; they are
accepted, validated and carried so that plan files stay interchangeable:

* the TPU tile geometry (``fused_rows/bc/bm``, ``cluster_bu/bs``): the
  CUDA kernels take no tile geometry (the pruned ones take only their
  own blocks, which the tile plans of ``kernels.stjoin.ops`` carry).
  ``cluster_tiles`` goes to the clustering entry points (``tiles=``) as
  in the reference, whose labels are bitwise the same for every pair,
  and the kernel wrappers accept it and read none of it;
* the collective schedules and payloads (``sim_strategy``, ``sim_dtype``,
  ``halo_stream``, ``sim_exchange``): only the multi-device program
  (``core/distributed.py``) reads them, as in the reference.

``use_kernel`` picks the join kernel of materialize mode only (K1, or K10
under ``use_index``): fused mode on the card always runs its kernels.
``None`` means "resolved at run time": ``sim_topk=None`` is K = 32 and
``sim_panel=None`` a panel height of at most 128, both against S.
"""
from __future__ import annotations

import dataclasses
import json

_MODES = ("materialize", "fused")
_ENGINES = ("rounds", "sequential")
_SIM_MODES = ("dense", "topk")
_SIM_STRATEGIES = ("psum", "allgather")
_SIM_DTYPES = ("f32", "bf16")
_HALO_STREAMS = ("barrier", "ring")
_SIM_EXCHANGES = ("allgather", "ring")


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """One per-stage engine configuration for the whole DSC pipeline
    (frozen and hashable, as the reference's)."""

    # ---- join (Problem 1) -------------------------------------------------
    mode: str = "materialize"          # "materialize" | "fused"
    use_kernel: bool = False           # CUDA join kernel (materialize only)
    use_index: bool = False            # grid candidate-tile pruning
                                       # (K10-K13 with the kernel plan)
    fused_rows: int | None = None      # TPU fused tile rows (not read)
    fused_bc: int = 16                 # TPU fused candidate rows (not read)
    fused_bm: int = 128                # TPU fused point chunk (not read)
    # ---- segmentation (Problem 2) ----------------------------------------
    seg_use_kernel: bool = False       # CUDA TSA2 Jaccard kernel
    # ---- similarity (SP relation) ----------------------------------------
    sim_mode: str = "dense"            # "dense" | "topk"
    sim_topk: int | None = None        # K of the top-K lists (None = 32)
    sim_panel: int | None = None       # panel height Sb (None = 128-snap)
    sim_strategy: str = "psum"         # distributed only
    sim_dtype: str = "f32"             # distributed only
    # ---- communication schedules (distributed only) -----------------------
    halo_stream: str = "barrier"       # "barrier" | "ring"
    sim_exchange: str = "allgather"    # "allgather" | "ring"
    # ---- clustering (Problem 3) ------------------------------------------
    cluster_engine: str = "rounds"     # "rounds" | "sequential"
    cluster_use_kernel: bool = False   # CUDA round-scan/claim-max kernels
    cluster_bu: int = 8                # TPU cluster tile rows (not read)
    cluster_bs: int = 128              # TPU cluster tile cols (not read)

    def validate(self) -> "EnginePlan":
        """Raise ``ValueError`` on any inconsistent field; return ``self``.

        The messages are the reference's, word for word.
        """
        if self.mode not in _MODES:
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.cluster_engine not in _ENGINES:
            raise ValueError(f"unknown cluster engine {self.cluster_engine!r}")
        if self.sim_mode not in _SIM_MODES:
            raise ValueError(f"unknown sim_mode {self.sim_mode!r}")
        if self.sim_strategy not in _SIM_STRATEGIES:
            raise ValueError(f"unknown sim_strategy {self.sim_strategy!r}")
        if self.sim_dtype not in _SIM_DTYPES:
            raise ValueError(f"unknown sim_dtype {self.sim_dtype!r}")
        if self.halo_stream not in _HALO_STREAMS:
            raise ValueError(f"unknown halo_stream {self.halo_stream!r}")
        if self.sim_exchange not in _SIM_EXCHANGES:
            raise ValueError(f"unknown sim_exchange {self.sim_exchange!r}")
        for name in ("fused_rows", "sim_topk", "sim_panel"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v < 1):
                raise ValueError(f"{name} must be None or a positive int, "
                                 f"got {v!r}")
        for name in ("fused_bc", "fused_bm", "cluster_bu", "cluster_bs"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        return self

    def replace(self, **kw) -> "EnginePlan":
        """A copy with fields replaced (validated)."""
        return dataclasses.replace(self, **kw).validate()

    @property
    def fused_tiles(self) -> tuple[int | None, int, int] | None:
        """``(rows, bc, bm)``, or ``None`` while every fused field holds
        the default (as the reference; no CUDA kernel reads it)."""
        t = (self.fused_rows, self.fused_bc, self.fused_bm)
        return None if t == (None, 16, 128) else t

    @property
    def cluster_tiles(self) -> tuple[int, int]:
        """``(bu, bs)``, the clustering entry points' ``tiles=`` (as the
        reference; no CUDA kernel reads it)."""
        return (self.cluster_bu, self.cluster_bs)

    # --------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EnginePlan":
        """Strict inverse of ``to_dict``: unknown keys raise; missing keys
        take the field default."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(
                f"unknown EnginePlan fields {sorted(unknown)}; "
                f"known fields: {sorted(names)}")
        return cls(**d).validate()

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "EnginePlan":
        return cls.from_dict(json.loads(s))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "EnginePlan":
        with open(path) as f:
            return cls.from_json(f.read())

    # ------------------------------------------------------- legacy aliases
    @classmethod
    def from_legacy(cls, *, mode: str = "materialize",
                    use_kernel: bool = False, use_index: bool = False,
                    fused_tiles: tuple | None = None,
                    seg_use_kernel: bool = False,
                    cluster_engine: str = "rounds",
                    cluster_use_kernel: bool = False,
                    sim_mode: str = "dense", sim_topk: int | None = None,
                    sim_panel: int | None = None,
                    sim_strategy: str = "psum",
                    sim_dtype: str = "f32",
                    halo_stream: str = "barrier",
                    sim_exchange: str = "allgather") -> "EnginePlan":
        """The plan of the deprecated per-stage flag set (the launcher's
        ``--mode``, ``--use-kernel``, ...), as the reference maps it."""
        rows, bc, bm = (None, 16, 128) if fused_tiles is None else fused_tiles
        return cls(mode=mode, use_kernel=use_kernel, use_index=use_index,
                   fused_rows=rows, fused_bc=bc, fused_bm=bm,
                   seg_use_kernel=seg_use_kernel,
                   cluster_engine=cluster_engine,
                   cluster_use_kernel=cluster_use_kernel,
                   sim_mode=sim_mode, sim_topk=sim_topk, sim_panel=sim_panel,
                   sim_strategy=sim_strategy,
                   sim_dtype=sim_dtype, halo_stream=halo_stream,
                   sim_exchange=sim_exchange).validate()


_LEGACY_DEFAULTS = {
    "mode": "materialize", "use_kernel": False, "use_index": False,
    "fused_tiles": None, "seg_use_kernel": False,
    "cluster_engine": "rounds", "cluster_use_kernel": False,
    "sim_mode": "dense", "sim_topk": None, "sim_panel": None,
    "sim_strategy": "psum", "sim_dtype": "f32",
    "halo_stream": "barrier", "sim_exchange": "allgather",
}


def resolve_plan(plan: EnginePlan | None = None, **legacy) -> EnginePlan:
    """The one entry-point rule: a plan, or the deprecated per-stage flags
    (``sim_mode=``, ``use_kernel=``, ... as ``EnginePlan.from_legacy``
    takes them) — never both.  ``plan=None`` materializes the plan of the
    flags (the default plan without any); with a plan, any flag at a
    non-default value raises, with the reference's messages."""
    unknown = set(legacy) - set(_LEGACY_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown legacy plan flags {sorted(unknown)}")
    if plan is None:
        return EnginePlan.from_legacy(**legacy)
    clash = {k: v for k, v in legacy.items()
             if v != _LEGACY_DEFAULTS[k] and v is not None}
    if clash:
        raise ValueError(
            f"both plan= and legacy per-stage flags were given ({clash}); "
            "the deprecated flags only exist to materialize a plan — "
            "set the fields on the plan instead")
    return plan.validate()
