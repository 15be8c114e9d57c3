"""End-to-end driver: distributed DSC over AIS-like maritime traffic.

Generates Brest-style lane traffic (variable sampling rate, temporal
displacement), temporally partitions it (equi-depth), and runs the
*distributed* pipeline on a ('part', 'model') = (4, 2) mesh: eight spawned
ranks over gloo, sharing the card (payloads staged through the host) or,
under ``--device cpu``, on the CPU.

    PYTHONPATH=src python -m repro_torch.examples.maritime_clustering [--device cpu]

On the card unless ``--device cpu`` asks for the CPU; with no card the
default raises.  ``main`` returns the ``DistributedDSCOutput``.
"""
import argparse

import numpy as np

from repro_torch.core.distributed import run_dsc_distributed
from repro_torch.core.partitioning import partition_batch
from repro_torch.core.types import DSCParams
from repro_torch.data.synthetic import ais_like, default_dsc_params_for
from repro_torch.distributed.mesh import Mesh
from repro_torch.kernels import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the ranks run (default: the card; raises "
                         "without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    batch, lanes = ais_like(n_vessels=48, n_lanes=4, max_points=96, seed=7,
                            device=dev)
    diam, mean_dt = default_dsc_params_for(batch)
    params = DSCParams(eps_sp=0.08 * diam, eps_t=2.0 * mean_dt,
                       delta_t=4.0 * mean_dt, w=6, tau=0.2,
                       alpha_sigma=-1.0, k_sigma=-1.0,
                       segmentation="tsa1")

    mesh = Mesh((4, 2), "gloo", device=dev.type,
                axis_names=("part", "model"))
    parts = partition_batch(batch, 4)
    out = run_dsc_distributed(parts, params, mesh, use_kernel=True)

    res = out.result
    member_of = res.member_of.cpu().numpy()
    is_rep = res.is_rep.cpu().numpy()
    reps = np.nonzero(is_rep)[0]
    maxs = params.max_subtrajs_per_traj
    print(f"vessels: {batch.num_trajs}, lanes: 4, partitions: 4, "
          f"model-parallel: 2")
    print(f"clusters: {len(reps)}, outliers: "
          f"{int(res.is_outlier.sum())}")
    for rep in reps[:10]:
        members = np.nonzero(member_of == rep)[0]
        vessels = sorted({int(m) // maxs for m in members})
        lane_ids = sorted({int(lanes[vv]) for vv in vessels})
        print(f"  cluster rep={int(rep)} size={len(members)} "
              f"lanes={lane_ids}")
    return out


if __name__ == "__main__":
    main()
