"""S2T-Clustering (Pelekis et al., EDBT 2017) — centralized baseline.

Two phases, per the original paper:
  NaTS — Neighborhood-aware Trajectory Segmentation: per-point voting from
         *continuous* trajectory neighborhoods, then homogeneity-driven
         segmentation (we reuse the windowed change detector).
  SaCO — Sampling, Clustering & Outliers: representatives are sampled as the
         highest-voted subtrajectories that are sufficiently *dissimilar*
         from already-selected ones; every other subtrajectory joins the
         most-similar representative (no delta_t minimum-duration constraint
         and no per-member similarity floor — the two differences the DSC
         paper credits for its lower RMSE in Fig. 7).

(Counterpart of ``repro.core.baselines.s2t``: NaTS runs the port's plain
DSC core on the batch's device, SaCO on the host.)
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import geometry, segmentation, similarity, voting
from repro_torch.core.types import TrajectoryBatch


def s2t_clustering(batch: TrajectoryBatch, eps_sp: float, eps_t: float,
                   w: int = 10, tau: float = 0.4, n_reps: int | None = None,
                   dissim: float = 0.6, max_subs: int = 8):
    """Returns dict(member_of, is_rep, is_outlier, table, sim)."""
    # NaTS: voting + segmentation (no delta_t filtering — S2T has none)
    join = geometry.best_match_join(batch, batch, eps_sp, eps_t)
    vote = voting.point_voting(join)
    nvote = voting.normalized_voting(vote, batch.valid)
    seg = segmentation.tsa1(nvote, batch.valid, w, tau, max_subs)
    table = similarity.build_subtraj_table(batch, seg, vote, max_subs)
    sim = similarity.similarity_matrix(join, seg, seg.sub_local, table,
                                       max_subs)

    sim_np = sim.cpu().numpy()
    voting_np = table.voting.cpu().numpy()
    valid_np = table.valid.cpu().numpy()
    S = len(voting_np)

    # SaCO sampling: greedy max-voting, dissimilarity-constrained seeds
    order = np.argsort(-np.where(valid_np, voting_np, -np.inf))
    reps: list[int] = []
    budget = n_reps if n_reps is not None else S
    for s in order:
        if not valid_np[s]:
            continue
        if all(sim_np[s, r] < dissim for r in reps):
            reps.append(int(s))
            if len(reps) >= budget:
                break

    member_of = np.full(S, -1, np.int64)
    member_sim = np.zeros(S)
    is_rep = np.zeros(S, bool)
    for r in reps:
        is_rep[r] = True
        member_of[r] = r
    for s in range(S):
        if not valid_np[s] or is_rep[s]:
            continue
        sims = sim_np[s, reps]
        j = int(np.argmax(sims))
        if sims[j] > 0.0:             # any positive similarity joins
            member_of[s] = reps[j]
            member_sim[s] = sims[j]
    is_outlier = valid_np & (member_of < 0)
    return {"member_of": member_of, "member_sim": member_sim,
            "is_rep": is_rep, "is_outlier": is_outlier,
            "table": table, "sim": sim_np, "seg": seg}
