"""DSC run configurations (the DSC part of ``repro.configs.registry``).

The reference's registry also lists the LM architectures and shapes;
those come with the port of the LM stack.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DSCRunConfig:
    """A DSC pipeline sizing (dataset capacities + parameters)."""
    name: str
    n_trajs: int          # T (row capacity, all partitions)
    max_points: int       # Mp per partition
    n_partitions_hint: int
    eps_sp: float = 0.1
    eps_t: float = 1.0
    delta_t: float = 0.0
    w: int = 10
    tau: float = 0.4
    alpha_sigma: float = 0.0
    k_sigma: float = 0.0
    max_subtrajs: int = 8
    segmentation: str = "tsa1"


DSC_CONFIGS = {
    # synthetic ground-truth scenario (Sec. 6.2)
    "dsc_synth": DSCRunConfig(name="dsc_synth", n_trajs=256, max_points=64,
                              n_partitions_hint=16),
    # Brest AIS-scale: 3.65e5 trajs, 17e6 points -> per-pod slice
    "dsc_brest": DSCRunConfig(name="dsc_brest", n_trajs=4096, max_points=128,
                              n_partitions_hint=32, w=20),
    # SIS urban-scale: 2.2e7 trajs, 7.2e8 points -> per-pod slice
    "dsc_sis": DSCRunConfig(name="dsc_sis", n_trajs=8192, max_points=128,
                            n_partitions_hint=32, w=20),
}


def get_dsc_config(name: str) -> DSCRunConfig:
    return DSC_CONFIGS[name]
