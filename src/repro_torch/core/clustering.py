"""Greedy SSCR clustering and outlier detection (Algorithm 4), on the
dense similarity matrix or on top-K neighbor lists (counterpart of
``repro.core.clustering``).

Subtrajectories are visited by voting descending; a visited slot that no
cluster has claimed and whose voting is >= k becomes a representative and
claims every alpha-adjacent slot that is unclaimed or claimed with a
strictly smaller similarity.  A visited unclaimed slot below k is an
outlier.  ``alpha`` and ``k`` resolve as ``mean + sigma * std`` of the
similarity / voting distribution unless absolute overrides are given.

Engines: ``"sequential"`` is the literal transcription (the parity
oracle); ``"rounds"`` resolves the representative set round by round —
every undecided slot with no undecided earlier alpha-neighbor at once —
then assigns members by one claim-max.  ``use_kernel=True`` runs each
round's scan and the claim-max through the CUDA kernels
(``repro_torch.kernels.cluster``) on CUDA tensors.

Every predicate of Algorithm 4 lives on alpha-edges, so on the
max-symmetrized matrix reduced to per-row top-K lists (``TopKSim``) each
slot's adjacency is its own list row.  The ``*_topk`` engines are then
label-identical to the dense ones whenever the spill certificate holds
(``similarity.topk_overflow``), at O(S*K) per sweep, and resolve alpha
from the moments the lists carry, bit-equal to the dense thresholds.
"""
from __future__ import annotations

import torch

from repro_torch.core.similarity import sim_row_moments
from repro_torch.core.types import (ClusteringResult, DSCParams,
                                    SubtrajTable, TopKSim, f32)
from repro_torch.kernels.cluster.ref import (claim_max_ref,
                                             topk_claim_max_ref,
                                             topk_round_scan_ref)


def resolve_thresholds_from_moments(params: DSCParams, moments,
                                    table: SubtrajTable):
    """Absolute (alpha, k) from per-row similarity moments (Sec. 6.1).

    The vector sums run in PyTorch's order, not XLA's, so alpha and k
    agree with the JAX package to ulps, not bits.
    """
    cnt, rsum, rsumsq = moments
    dev = rsum.device
    n_pos = cnt.sum().clamp_min(1)
    s_mean = rsum.sum() / n_pos
    s_var = (rsumsq.sum() / n_pos - s_mean * s_mean).clamp_min(0.0)
    alpha_abs, k_abs = f32(params.alpha_abs, dev), f32(params.k_abs, dev)
    alpha = torch.where(alpha_abs >= 0.0, alpha_abs,
                        s_mean + f32(params.alpha_sigma, dev)
                        * torch.sqrt(s_var))

    nv = table.valid.sum().clamp_min(1)
    v_mean = torch.where(table.valid, table.voting, 0.0).sum() / nv
    v_var = torch.where(table.valid, (table.voting - v_mean) ** 2,
                        0.0).sum() / nv
    k = torch.where(k_abs >= 0.0, k_abs,
                    v_mean + f32(params.k_sigma, dev) * torch.sqrt(v_var))
    return alpha, k


def resolve_thresholds(params: DSCParams, sim: torch.Tensor,
                       table: SubtrajTable):
    """Absolute (alpha, k) from a dense similarity matrix."""
    moments = sim_row_moments(sim, table.valid, table.valid)
    return resolve_thresholds_from_moments(params, moments, table)


def visit_order(table: SubtrajTable):
    """(order, rank): valid slots by voting descending, ties by slot index
    (stable sort), invalid slots last; ``rank`` inverts ``order``."""
    S = table.num_slots
    key = torch.where(table.valid, table.voting, float("-inf"))
    order = torch.argsort(-key, stable=True).to(torch.int32)
    rank = torch.empty((S,), dtype=torch.int32, device=key.device)
    rank[order.long()] = torch.arange(S, dtype=torch.int32,
                                      device=key.device)
    return order, rank


def _sequential(table: SubtrajTable, alpha, k, claim_row):
    """Algorithm 4, one visited slot at a time.  ``claim_row(s)`` returns
    ``(slots, sims)``: the candidate neighbors of ``s`` and their
    similarity (a dense row, or ``s``'s list row)."""
    S = table.num_slots
    dev = table.valid.device
    order, _ = visit_order(table)
    member_of = torch.full((S,), -1, dtype=torch.int32, device=dev)
    member_sim = torch.zeros((S,), dtype=torch.float32, device=dev)
    is_rep = torch.zeros((S,), dtype=torch.bool, device=dev)
    # the per-slot decision reads f32 values exactly as Python floats
    potential = (table.valid & (table.voting >= k)).tolist()
    for s in order.tolist():
        if not potential[s] or member_of[s] >= 0 or is_rep[s]:
            continue
        u, w = claim_row(s)
        claim = (table.valid[u] & (w > 0.0) & (w >= alpha) & ~is_rep[u]
                 & (u != s) & (w > member_sim[u]))
        member_of[u[claim]] = s
        member_sim[u[claim]] = w[claim]
        member_of[s] = s
        member_sim[s] = float("inf")
        is_rep[s] = True
    return ClusteringResult(
        member_of=member_of,
        member_sim=torch.where(is_rep, float("inf"), member_sim),
        is_rep=is_rep, is_outlier=table.valid & (member_of < 0),
        alpha_used=alpha, k_used=k)


def cluster_sequential(sim: torch.Tensor, table: SubtrajTable,
                       params: DSCParams) -> ClusteringResult:
    """Algorithm 4 on the dense matrix: the parity oracle."""
    alpha, k = resolve_thresholds(params, sim, table)
    slots = torch.arange(table.num_slots, device=sim.device)
    return _sequential(table, alpha, k, lambda s: (slots, sim[s]))


def _topk_thresholds(topk: TopKSim, table: SubtrajTable, params: DSCParams):
    return resolve_thresholds_from_moments(
        params, (topk.degree, topk.row_sum, topk.row_sumsq), table)


def cluster_sequential_topk(topk: TopKSim, table: SubtrajTable,
                            params: DSCParams) -> ClusteringResult:
    """Algorithm 4 over neighbor lists, each visited slot's adjacency read
    from its ``[K]`` list row: the parity oracle of
    ``cluster_rounds_topk``.  Padding entries (id -1) are dropped; the ids
    of a row are distinct, so no slot is claimed twice in one visit."""
    alpha, k = _topk_thresholds(topk, table, params)

    def claim_row(s):
        keep = topk.ids[s] >= 0
        return topk.ids[s][keep].long(), topk.sims[s][keep]

    return _sequential(table, alpha, k, claim_row)


def _rounds(table: SubtrajTable, alpha, k, scan, assign, *,
            seed_resolved=None, seed_is_rep=None):
    """The round loop shared by both representations: ``(result,
    rounds)``.  A Python loop with one host sync per round (the test of
    whether every slot is resolved)."""
    S = table.num_slots
    potential = table.valid & (table.voting >= k)
    resolved = ~potential
    is_rep = torch.zeros_like(potential)
    if seed_resolved is not None:
        resolved = resolved | seed_resolved
        is_rep = is_rep | (seed_is_rep & seed_resolved & potential)
    rounds = 0
    while not bool(resolved.all()):
        unresolved = ~resolved
        blocked, claimed = scan(unresolved, is_rep)
        frontier = unresolved & (~blocked | claimed)
        is_rep = is_rep | (frontier & ~claimed)
        resolved = resolved | frontier
        rounds += 1

    member_sim, member_of = assign(is_rep)
    slots = torch.arange(S, dtype=torch.int32, device=potential.device)
    member_of = torch.where(is_rep, slots, member_of)
    member_sim = torch.where(is_rep, float("inf"), member_sim)
    result = ClusteringResult(
        member_of=member_of, member_sim=member_sim, is_rep=is_rep,
        is_outlier=table.valid & (member_of < 0), alpha_used=alpha,
        k_used=k)
    return result, rounds


def cluster_rounds(sim: torch.Tensor, table: SubtrajTable, params: DSCParams,
                   *, use_kernel: bool = False, with_rounds: bool = False):
    """Round-parallel Algorithm 4 — label-identical to the oracle.

    ``use_kernel=True`` runs each round's scan and the final claim-max
    through the CUDA kernels; the plain path builds the alpha-edge
    predicate once and reduces each round to two 0/1 vector-matrix
    products (exact: the sums are integers below 2^24).
    ``with_rounds=True`` also returns the number of rounds.
    """
    alpha, k = resolve_thresholds(params, sim, table)
    order, rank = visit_order(table)

    if use_kernel:
        from repro_torch.kernels.cluster.ops import (cluster_assign,
                                                     cluster_round_scan)

        def scan(unresolved, is_rep):
            return cluster_round_scan(sim, rank, unresolved, is_rep, alpha)

        def assign(is_rep):
            return cluster_assign(sim, rank, is_rep, table.valid, alpha)
    else:
        predf = ((sim > 0.0) & (sim >= alpha)
                 & (rank[:, None] < rank[None, :])).to(torch.float32)

        def scan(unresolved, is_rep):
            blocked = (unresolved.to(torch.float32) @ predf) > 0.0
            claimed = (is_rep.to(torch.float32) @ predf) > 0.0
            return blocked, claimed

        def assign(is_rep):
            return claim_max_ref(sim, order, rank, is_rep, table.valid,
                                 alpha)

    result, rounds = _rounds(table, alpha, k, scan, assign)
    return (result, rounds) if with_rounds else result


def cluster_rounds_topk(topk: TopKSim, table: SubtrajTable,
                        params: DSCParams, *, use_kernel: bool = False,
                        with_rounds: bool = False, seed_resolved=None,
                        seed_is_rep=None):
    """Round-parallel Algorithm 4 over ``[S, K]`` neighbor lists: the
    recurrence and claim-max of ``cluster_rounds``, each reduction over
    the lists.  ``use_kernel=True`` runs them through the CUDA list
    kernels (K8, K9) on CUDA tensors; label-identical either way.

    ``seed_resolved`` / ``seed_is_rep`` ([S] bool) warm-start the
    recurrence from an earlier solve: slots marked resolved enter round 0
    decided, with ``seed_is_rep`` as their verdict.  The seeds must be a
    visit-order prefix of this instance whose rank, potential and list
    rows are unchanged; then the warm run's labels equal a cold run's.
    The claim-max is always recomputed in full.
    """
    alpha, k = _topk_thresholds(topk, table, params)
    _, rank = visit_order(table)

    if use_kernel:
        from repro_torch.kernels.cluster.ops import (
            topk_cluster_assign, topk_cluster_round_scan)
        scan_fn, assign_fn = topk_cluster_round_scan, topk_cluster_assign
    else:
        scan_fn, assign_fn = topk_round_scan_ref, topk_claim_max_ref

    def scan(unresolved, is_rep):
        return scan_fn(topk.ids, topk.sims, rank, unresolved, is_rep, alpha)

    def assign(is_rep):
        return assign_fn(topk.ids, topk.sims, rank, is_rep, table.valid,
                         alpha)

    result, rounds = _rounds(table, alpha, k, scan, assign,
                             seed_resolved=seed_resolved,
                             seed_is_rep=seed_is_rep)
    return (result, rounds) if with_rounds else result


def cluster(sim, table: SubtrajTable, params: DSCParams,
            engine: str = "rounds", *, use_kernel: bool = False,
            with_rounds: bool = False):
    """Problem 3 entry point: ``sim`` is the dense ``[S, S]`` matrix or a
    ``TopKSim``; ``engine`` is ``"rounds"`` or the ``"sequential"``
    oracle.  ``with_rounds=True`` returns ``(result, rounds)``; the
    sequential oracle reports ``rounds = None``.
    """
    if isinstance(sim, TopKSim):
        if engine == "sequential":
            res = cluster_sequential_topk(sim, table, params)
            return (res, None) if with_rounds else res
        if engine == "rounds":
            return cluster_rounds_topk(sim, table, params,
                                       use_kernel=use_kernel,
                                       with_rounds=with_rounds)
        raise ValueError(f"unknown cluster engine {engine!r}")
    if engine == "sequential":
        res = cluster_sequential(sim, table, params)
        return (res, None) if with_rounds else res
    if engine == "rounds":
        return cluster_rounds(sim, table, params, use_kernel=use_kernel,
                              with_rounds=with_rounds)
    raise ValueError(f"unknown cluster engine {engine!r}")


def sscr(result: ClusteringResult, sim: torch.Tensor) -> torch.Tensor:
    """Eq. 3 objective: sum of member->representative similarities."""
    S = sim.shape[0]
    member = (~result.is_rep) & (result.member_of >= 0)
    rep = result.member_of.clamp(0, S - 1).long()
    vals = sim[torch.arange(S, device=sim.device), rep]
    return torch.where(member, vals, 0.0).sum()


def rmse(result: ClusteringResult, sim: torch.Tensor, eps_sp) -> torch.Tensor:
    """Intra-cluster RMSE (Sec. 6.2): a member's mean distance to its
    representative is ``eps_sp * (1 - Sim)`` (Lemma 1)."""
    S = sim.shape[0]
    member = (~result.is_rep) & (result.member_of >= 0)
    rep = result.member_of.clamp(0, S - 1).long()
    s = sim[torch.arange(S, device=sim.device), rep].clamp(0.0, 1.0)
    d = f32(eps_sp, sim.device) * (1.0 - s)
    n = member.sum().clamp_min(1)
    return torch.sqrt(torch.where(member, d * d, 0.0).sum() / n)


def sscr_from_result(result: ClusteringResult) -> torch.Tensor:
    """Eq. 3 from the clustering result alone: a member's ``member_sim``
    is its similarity to its representative (the claim-max value), so the
    top-K path scores without ``[S, S]``; bit-equal to ``sscr`` on the
    dense path."""
    member = (~result.is_rep) & (result.member_of >= 0)
    return torch.where(member, result.member_sim, 0.0).sum()


def rmse_from_result(result: ClusteringResult, eps_sp) -> torch.Tensor:
    """Sec. 6.2 RMSE from the clustering result alone (cf. ``rmse``)."""
    member = (~result.is_rep) & (result.member_of >= 0)
    s = torch.where(member, result.member_sim, 0.0).clamp(0.0, 1.0)
    d = f32(eps_sp, s.device) * (1.0 - s)
    n = member.sum().clamp_min(1)
    return torch.sqrt(torch.where(member, d * d, 0.0).sum() / n)
