"""Quickstart: subtrajectory clustering on the paper's Fig. 1 scenario.

Runs the full DSC pipeline (join -> voting -> TSA2 segmentation ->
similarity -> clustering + outliers) on six synthetic routes through a
common midpoint, and prints the recovered structure: the shared legs become
clusters; the unshared tails become outliers.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card unless ``--device cpu`` asks for the CPU; with no card the
default raises.  ``main`` returns the ``DSCOutput``.
"""
import argparse

from repro_torch.core.dsc import cluster_summary, run_dsc
from repro_torch.core.types import DSCParams
from repro_torch.data.synthetic import figure1_scenario, route_origins_dests
from repro_torch.kernels import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the pipeline runs (default: the card; "
                         "raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    batch, routes = figure1_scenario(n_per_route=4, points_per_leg=24,
                                     seed=0, device=dev)
    params = DSCParams(eps_sp=0.42, eps_t=1.0, delta_t=0.0, w=6, tau=0.15,
                       alpha_sigma=-1.0, k_sigma=-1.0, segmentation="tsa2")
    out = run_dsc(batch, params, device=dev)
    s = cluster_summary(out)

    origins, dests = route_origins_dests(routes)
    maxs = params.max_subtrajs_per_traj
    t = batch.t.cpu().numpy()
    v = batch.valid.cpu().numpy()
    t_split = float(t[v].max()) / 2
    sub_local = out.seg.sub_local.cpu().numpy()

    def leg_of(slot):
        r, k = divmod(slot, maxs)
        sel = (sub_local[r] == k) & v[r]
        if not sel.any():
            return "?"
        if t[r][sel].mean() < t_split:
            return f"{origins[r]}->O"
        return f"O->{dests[r]}"

    print(f"clusters: {s['num_clusters']}  outliers: "
          f"{len(s['outliers'])}  RMSE: {s['rmse']:.4f}")
    for rep, members in sorted(s["clusters"].items(),
                               key=lambda kv: -len(kv[1])):
        legs = sorted({leg_of(m) for m in members})
        print(f"  cluster(rep={rep:4d}, size={len(members):3d}): "
              f"legs {legs}")
    out_legs = sorted({leg_of(o) for o in s["outliers"]})
    print(f"  outliers: legs {out_legs}  "
          "(the unshared O->A / O->B tails — Fig. 1(b))")
    return out


if __name__ == "__main__":
    main()
