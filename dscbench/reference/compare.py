"""The comparison that decides ``correct``: the program's outputs of one
job, layer by layer, against the reference's of the same slice.

Each number is a reading with a limit of its own (the cell file's
``checks``); a run is correct when every reading is at or below its limit
and finite.  The readings:

* ``vote``: the largest gap of a point vote or a slot voting, as a share
  of the largest reference value (join_vote);
* ``tsa2_d``: the largest gap of the TSA2 signal, a Jaccard distance in
  [0, 1]: it is a function of the neighbour words alone (join_vote);
* ``segments``: points whose subtrajectory differs, plus slots whose
  validity, cardinality or time span differs (segmentation);
* ``sim``: the largest gap of the dense ``[S, S]`` matrix (similarity,
  dense plans);
* ``topk_k`` and ``topk_lists``: the gap of the final K, and the list
  entries (id or value) that differ from the reference rows' top K
  (similarity, top-K plans);
* ``thresholds``: the larger relative gap of alpha and k (clustering);
* ``labels``: the most slots whose ``member_of``, ``is_rep`` or
  ``is_outlier`` differ (``label_gaps``), over every job of the window
  and each job's own slice (clustering: the answer the user waits for).

A value that is not finite where the reference's is makes its reading NaN
(or infinite), and so fails.
"""
from __future__ import annotations

import math

import torch

from dscbench.reference.pipeline import ROW_BLOCK, Reference


def _max_rel(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> float:
    """max |a - b| over ``mask`` as a share of max |b| there."""
    if not bool(mask.any()):
        return 0.0
    gap = (a.float() - b.float()).abs()[mask].max()
    scale = b.float().abs()[mask].max().clamp_min(1e-30)
    return float(gap / scale)


def _max_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| by row blocks; NaN as soon as a block holds a NaN
    (``torch.max`` keeps it, Python's ``max`` would drop it)."""
    gap = 0.0
    for i0 in range(0, a.shape[0], ROW_BLOCK):
        d = (a[i0:i0 + ROW_BLOCK].float() - b[i0:i0 + ROW_BLOCK].float()).abs()
        if d.numel():
            m = float(d.max())
            if math.isnan(m):
                return m
            gap = max(gap, m)
    return gap


def _topk_rows(sim_rows: torch.Tensor, k: int):
    """The reference rows' top K: values descending, ties by ascending
    column, ids -1 and values 0 where not positive."""
    vals, idx = torch.sort(sim_rows, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    return torch.where(vals > 0.0, idx, -1), vals.clamp_min(0.0)


def label_gaps(labels, ref: Reference) -> int:
    """Slots whose ``(member_of, is_rep, is_outlier)`` differ."""
    member_of, is_rep, is_out = labels
    if member_of.shape != ref.member_of.shape:
        return ref.member_of.shape[0]
    bad = ((member_of != ref.member_of) | (is_rep != ref.is_rep)
           | (is_out != ref.is_outlier))
    return int(bad.sum())


def readings(out, ref: Reference, sim_mode: str,
             topk_k0: int) -> dict[str, float]:
    """Every layer's reading of one cell kind but ``labels``; ``out`` is
    the program's output of the checked job."""
    dev = ref.vote.device
    valid_pt = ref.sub_local >= 0
    r = {}
    r["vote"] = max(_max_rel(out.vote.to(dev), ref.vote, valid_pt),
                    _max_rel(out.table.voting.to(dev), ref.voting,
                             ref.valid))
    r["tsa2_d"] = _max_gap(out.seg.score.to(dev), ref.score)
    seg = int((out.seg.sub_local.to(dev).long() != ref.sub_local).sum())
    tab = out.table
    slot = ((tab.valid.to(dev) != ref.valid)
            | (tab.card.to(dev).long() != ref.card)
            | (tab.t_start.to(dev).float() != ref.t_start.float())
            | (tab.t_end.to(dev).float() != ref.t_end.float()))
    r["segments"] = float(seg + int(slot.sum()))
    if sim_mode == "dense":
        r["sim"] = _max_gap(out.sim, ref.sim.to(out.sim.device))
    else:
        lists = out.sim_topk
        k_ref = ref.topk_k(topk_k0)
        r["topk_k"] = float(abs(lists.k - k_ref))
        k = min(lists.k, k_ref)
        differ = 0
        for i0 in range(0, ref.sim.shape[0], ROW_BLOCK):
            ids, vals = _topk_rows(ref.sim[i0:i0 + ROW_BLOCK], k)
            pid = lists.ids[i0:i0 + ROW_BLOCK, :k].to(dev).long()
            pval = lists.sims[i0:i0 + ROW_BLOCK, :k].to(dev).float()
            differ += int(((pid != ids) | (pval != vals.float())).sum())
        r["topk_lists"] = float(differ)
    alpha = float(out.result.alpha_used)
    k_used = float(out.result.k_used)
    r["thresholds"] = max(abs(alpha - ref.alpha) / max(abs(ref.alpha), 1e-30),
                          abs(k_used - ref.k) / max(abs(ref.k), 1e-30))
    return r


def verdict(values: dict[str, float], limits: dict[str, float]):
    """``(correct, checks)``: checks maps each name to its reading and
    limit; a reading that is missing, not finite or above its limit fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = values.get(name, float("nan"))
        checks[name] = {"value": v, "limit": limit}
        if not (math.isfinite(v) and v <= limit):
            ok = False
    return ok, checks


class RefOutput:
    """A reference run dressed as a program output (the control in the
    program's place), with top-K lists at K when asked."""

    def __init__(self, ref: Reference, sim_mode: str, k: int | None = None):
        from types import SimpleNamespace as NS
        self.vote = ref.vote
        self.seg = NS(score=ref.score, sub_local=ref.sub_local)
        self.table = NS(valid=ref.valid, card=ref.card, t_start=ref.t_start,
                        t_end=ref.t_end, voting=ref.voting)
        self.result = NS(alpha_used=ref.alpha, k_used=ref.k)
        self.sim = ref.sim if sim_mode == "dense" else None
        self.sim_topk = None
        if sim_mode != "dense":
            parts = [_topk_rows(ref.sim[i0:i0 + ROW_BLOCK], k)
                     for i0 in range(0, ref.sim.shape[0], ROW_BLOCK)]
            ids = torch.cat([p[0] for p in parts])
            sims = torch.cat([p[1] for p in parts])
            self.sim_topk = NS(ids=ids, sims=sims, k=k)

