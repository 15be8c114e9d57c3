"""Cross-partition refinement (Algorithm 5) — counterpart of
``repro.core.refine``.

A subtrajectory replicated in several temporal partitions may receive
contradicting states (Repr / Cluster-member / Outlier).  The paper's case
table (a)-(f) reduces, for every replicated subtrajectory, to one rule:

    Repr anywhere                      -> Repr          (cases b, d, e)
    else member anywhere               -> member of the cluster with the
                                          max similarity  (cases c, f)
    else                               -> outlier       (case a, dedup)
"""
from __future__ import annotations

import torch

from repro_torch.core.types import ClusteringResult


def refine_states(member_of: torch.Tensor, member_sim: torch.Tensor,
                  is_rep: torch.Tensor, valid: torch.Tensor,
                  alpha: torch.Tensor, k: torch.Tensor) -> ClusteringResult:
    """Reduce per-partition states ``[P, S]`` to one consistent global
    state ``[S]``.  ``member_of`` holds global representative slot ids (or
    -1).  The best partition of a member is the first of the largest
    similarity (``torch.argmax`` returns the first maximum, as
    ``jnp.argmax`` does)."""
    P, S = member_of.shape
    any_rep = (is_rep & valid).any(dim=0)

    sim_masked = torch.where(valid & (member_of >= 0) & ~is_rep,
                             member_sim, float("-inf"))
    best_p = sim_masked.argmax(dim=0, keepdim=True)
    best_sim = sim_masked.gather(0, best_p)[0]
    best_of = member_of.gather(0, best_p)[0]
    # finite sims for real members, -inf elsewhere (a rep's +inf is masked
    # out by ~is_rep): finiteness alone decides membership
    has_member = torch.isfinite(best_sim)

    slot = torch.arange(S, dtype=torch.int32, device=member_of.device)
    member_of_out = torch.where(
        any_rep, slot, torch.where(has_member, best_of, -1)).to(torch.int32)
    member_sim_out = torch.where(
        any_rep, float("inf"), torch.where(has_member, best_sim, 0.0))
    seen = valid.any(dim=0)
    is_outlier = seen & ~any_rep & ~has_member
    return ClusteringResult(
        member_of=torch.where(seen, member_of_out, -1).to(torch.int32),
        member_sim=torch.where(seen, member_sim_out, 0.0),
        is_rep=any_rep & seen,
        is_outlier=is_outlier,
        alpha_used=alpha, k_used=k)
