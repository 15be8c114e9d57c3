"""Mixture-of-Experts FFN, one device (the port of ``repro.models.moe``'s
local path, ``axis_name=None``).

Tokens are routed top-k, packed into fixed-capacity per-expert buffers,
processed as dense [E, cap, D] GEMMs and combined with their gates.
Capacity: ``C = ceil(N*k/E * capacity_factor)``; overflow tokens are dropped
(their gate mass is lost, surfaced via the returned ``dropped`` fraction).
Experts are padded up to a multiple of the EP degree; padded experts are
masked out of the router.

Routing keeps the reference's tie order: ``lax.top_k`` takes equal
probabilities in ascending expert order, and so does a stable descending
sort (``torch.topk`` promises no order).  The expert-parallel branches of
the reference (``axis_name`` given, ``moe_ffn_shard_map``, the int8
dispatch) belong to the distributed-LM slice and raise here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import COMPUTE_DTYPE, F32, _bf16, _normal

EP_NOT_PORTED = ("expert parallelism (axis_name, moe_ffn_shard_map, the "
                 "int8 dispatch) comes with the distributed-LM slice of "
                 "the port (ROADMAP Queue 1)")


def padded_experts(cfg: MoEConfig, ep_degree: int) -> int:
    return -(-cfg.n_experts // ep_degree) * ep_degree


def init_moe(d_model: int, cfg: MoEConfig, generator, device=None,
             ep_degree: int = 1):
    E = padded_experts(cfg, ep_degree)
    s = 1.0 / math.sqrt(d_model)

    def nrm(shape, scale):
        return _normal(shape, generator, device, scale)

    p = {
        "router": nrm((d_model, E), s),
        "w_gate": nrm((E, d_model, cfg.d_expert), s),
        "w_up": nrm((E, d_model, cfg.d_expert), s),
        "w_down": nrm((E, cfg.d_expert, d_model),
                      1.0 / math.sqrt(cfg.d_expert)),
    }
    if cfg.n_shared > 0:
        f = cfg.n_shared * cfg.d_expert
        p["ws_gate"] = nrm((d_model, f), s)
        p["ws_up"] = nrm((d_model, f), s)
        p["ws_down"] = nrm((f, d_model), 1.0 / math.sqrt(f))
    return p


def _capacity(n_tokens: int, k: int, E: int, factor: float) -> int:
    c = int(n_tokens * k / E * factor) + 1
    return -(-c // 4) * 4


def _top_k(probs, k: int):
    """``lax.top_k``: the k largest per row, equal values in ascending
    index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits, cfg: MoEConfig, E: int):
    """Softmax routing over the real experts: (probs, gates, expert ids)."""
    if cfg.n_experts < E:                       # mask padded experts
        pad_mask = torch.arange(E, device=logits.device) >= cfg.n_experts
        logits = torch.where(pad_mask[None, :], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = _top_k(probs, cfg.top_k)      # [N, k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, eidx


def moe_ffn(p, x, cfg: MoEConfig, *, axis_name: str | None = None,
            quantize_dispatch: bool = False,
            shared_sharded: bool = False):
    """x: [B, L, D].  Returns (y, aux_loss, dropped_fraction)."""
    if axis_name is not None or quantize_dispatch or shared_sharded:
        raise NotImplementedError(EP_NOT_PORTED)
    B, L, D = x.shape
    N = B * L
    dev = x.device
    xt = _bf16(x.reshape(N, D))
    E = p["router"].shape[1]
    k = cfg.top_k
    C = _capacity(N, k, E, cfg.capacity_factor)

    # ---- routing ----
    logits = (xt @ _bf16(p["router"])).to(F32)
    probs, gates, eidx = _route(logits, cfg, E)

    # switch-style load-balance aux: E * sum_e f_e * p_e
    onehot_top1 = F.one_hot(eidx[:, 0], E).to(F32)
    f_e = onehot_top1.mean(0)
    p_e = probs.mean(0)
    aux = E * torch.sum(f_e * p_e)

    # ---- dispatch bookkeeping (sort-based ranking) ----
    flat_e = eidx.reshape(-1)                   # [N*k]
    flat_g = _bf16(gates.reshape(-1))
    ar = torch.arange(N * k, device=dev)
    src_row = ar // k
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=dev),
                               side="left")
    rank_sorted = ar - first[sorted_e]
    rank = torch.zeros((N * k,), dtype=torch.int64, device=dev)
    rank[order] = rank_sorted
    keep = rank < C
    dropped = 1.0 - keep.to(F32).mean()

    dst_e = torch.where(keep, flat_e, E)        # E = garbage bin row
    dst_c = torch.where(keep, rank, 0)

    buf = torch.zeros((E + 1, C, D), dtype=COMPUTE_DTYPE, device=dev)
    buf[dst_e, dst_c] = xt[src_row]
    hbuf = buf[:E]                              # [E, C, D]

    g = torch.einsum("ecd,edf->ecf", hbuf, _bf16(p["w_gate"]))
    u = torch.einsum("ecd,edf->ecf", hbuf, _bf16(p["w_up"]))
    h = F.silu(g) * u
    out = torch.einsum("ecf,efd->ecd", h, _bf16(p["w_down"]))

    # ---- combine ----
    vals = out[torch.clamp(dst_e, 0, E - 1), dst_c]          # [N*k, D]
    vals = vals * (flat_g * keep.to(COMPUTE_DTYPE))[:, None]
    # the reference's scatter-add of each row's k slots, in slot order
    vals = vals.reshape(N, k, D)
    y = torch.zeros((N, D), dtype=COMPUTE_DTYPE, device=dev)
    for j in range(k):
        y = y + vals[:, j]

    # ---- shared experts (always-on) ----
    if "ws_gate" in p:
        sg = F.silu(xt @ _bf16(p["ws_gate"]))
        su = xt @ _bf16(p["ws_up"])
        y = y + (sg * su) @ _bf16(p["ws_down"])

    return y.reshape(B, L, D).to(x.dtype), aux, dropped


def moe_ffn_shard_map(*args, **kwargs):
    raise NotImplementedError(EP_NOT_PORTED)


def moe_ffn_dense_ref(p, x, cfg: MoEConfig):
    """Oracle: computes every expert densely and combines with router
    weights: no capacity, no drops.  For tests only (O(E) compute)."""
    B, L, D = x.shape
    xt = x.reshape(B * L, D).to(F32)
    E = p["router"].shape[1]
    _, gates, eidx = _route(xt @ p["router"], cfg, E)
    g = torch.einsum("nd,edf->enf", xt, p["w_gate"])
    u = torch.einsum("nd,edf->enf", xt, p["w_up"])
    h = F.silu(g) * u
    out = torch.einsum("enf,efd->end", h, p["w_down"])     # [E, N, D]
    w = torch.zeros((B * L, E), dtype=F32, device=x.device)
    w.scatter_add_(1, eidx, gates)
    y = torch.einsum("ne,end->nd", w, out)
    if "ws_gate" in p:
        y = y + (F.silu(xt @ p["ws_gate"]) * (xt @ p["ws_up"])) \
            @ p["ws_down"]
    return y.reshape(B, L, D).to(x.dtype)
