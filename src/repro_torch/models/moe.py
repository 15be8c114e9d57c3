"""Mixture-of-Experts FFN with explicit expert parallelism (the port of
``repro.models.moe``).

Expert-parallel path (``axis_name`` given, inside ``shard_map`` on a mesh
rank): tokens are routed top-k, packed into fixed-capacity per-expert
buffers, exchanged with one ``all_to_all`` over the 'model' axis (EP),
processed as dense [E_local, m*cap, D] GEMMs on the expert owners, and
returned with the inverse ``all_to_all``.  ``moe_ffn_shard_map`` runs it
on global arrays (``distributed/mesh.py::shard_map``): the batch sharded
over the DP axes, the experts over 'model'; ``aux`` and ``dropped`` are
computed per data shard, then ``pmean``'d over every axis, as the
reference does (not the global batch's aux: it is nonlinear in the token
set).

Local path (``axis_name=None``): the same math on one device (m=1).

Capacity: ``C = ceil(N*k/E * capacity_factor)`` from the local token
count; overflow tokens are dropped (their gate mass is lost, surfaced via
the returned ``dropped`` fraction).  Experts are padded up to a multiple
of the EP degree; padded experts are masked out of the router.

Routing keeps the reference's tie order: ``lax.top_k`` takes equal
probabilities in ascending expert order, and so does a stable descending
sort (``torch.topk`` promises no order).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import mesh as mesh_mod
from repro_torch.distributed.mesh import P
from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import COMPUTE_DTYPE, F32, _bf16, _normal


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


def _quant_dispatch(buf):
    """Per-row symmetric int8 quantization for the EP all_to_all payload
    (DeepSeek-V3-style low-precision dispatch): 2x fewer bytes on the wire
    than bf16; the scales ride along as f32 per (expert, slot).  ``round``
    is half to even in both packages."""
    b = buf.to(F32)
    amax = torch.amax(torch.abs(b), dim=-1, keepdim=True)
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(b / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_dispatch(q, scale):
    return (q.to(F32) * scale).to(COMPUTE_DTYPE)


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
    """x: [B, L, D] (the rank's block when inside ``shard_map``).
    Returns (y, aux_loss, dropped_fraction)."""
    B, L, D = x.shape
    N = B * L
    dev = x.device
    xt = _bf16(x.reshape(N, D))
    comm = None if axis_name is None else mesh_mod.axis_comm(axis_name,
                                                             "moe_ffn")
    m = 1 if comm is None else comm.axis_size(axis_name)
    E = p["router"].shape[1]
    E_loc = E // m
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
    buf = buf[:E]                               # [E, C, D]

    # ---- EP exchange ----
    if comm is not None:
        if quantize_dispatch:
            q, scale = _quant_dispatch(buf)
            qs = comm.all_to_all(q.reshape(m, E_loc, C, D), axis_name, 0, 0)
            ss = comm.all_to_all(scale.reshape(m, E_loc, C, 1), axis_name,
                                 0, 0)
            recv = _dequant_dispatch(qs, ss)
        else:
            recv = comm.all_to_all(buf.reshape(m, E_loc, C, D), axis_name,
                                   0, 0)
        # [m(src), E_loc, C, D] -> [E_loc, m*C, D]
        hbuf = torch.movedim(recv, 0, 1).reshape(E_loc, m * C, D)
    else:
        hbuf = buf

    g = torch.einsum("ecd,edf->ecf", hbuf, _bf16(p["w_gate"]))
    u = torch.einsum("ecd,edf->ecf", hbuf, _bf16(p["w_up"]))
    h = F.silu(g) * u
    out = torch.einsum("ecf,efd->ecd", h, _bf16(p["w_down"]))

    if comm is not None:
        back = torch.movedim(out.reshape(E_loc, m, C, D), 1, 0)
        ret = comm.all_to_all(back, axis_name, 0, 0).reshape(E, C, D)
    else:
        ret = out

    # ---- combine ----
    vals = ret[torch.clamp(dst_e, 0, E - 1), dst_c]          # [N*k, D]
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
        ysh = (sg * su) @ _bf16(p["ws_down"])
        if shared_sharded and comm is not None:
            # column-sharded shared experts under EP: partial sums
            ysh = comm.psum(ysh, axis_name)
        y = y + ysh

    return y.reshape(B, L, D).to(x.dtype), aux, dropped


def moe_ffn_shard_map(p, x, cfg: MoEConfig, mesh, dp_axes: tuple,
                      model_axis: str = "model",
                      quantize_dispatch: bool = False):
    """EP wrapper: ``moe_ffn`` inside ``shard_map`` on ``mesh`` (run on
    each of its ranks, every rank passing the same global ``p`` and
    ``x``), so the dispatch / return all_to_alls are real collectives over
    ``model``.  Returns the global (y, aux, dropped) on every rank."""
    bspec = dp_axes if len(dp_axes) != 1 else dp_axes[0]
    x_spec = P(bspec, None, None)
    m = mesh.shape[model_axis]

    def pspec(name, leaf):
        if name in ("w_gate", "w_up", "w_down"):
            return P(*(("model",) + (None,) * (leaf.ndim - 1)))
        if name in ("ws_gate", "ws_up"):
            return P(None, "model") if leaf.shape[1] % m == 0 else P()
        if name == "ws_down":
            return P("model", None) if leaf.shape[0] % m == 0 else P()
        return P()

    p_specs = {k: pspec(k, v) for k, v in p.items()}
    all_axes = tuple(dp_axes) + (model_axis,)
    shared_sharded = "ws_gate" in p and p["ws_gate"].shape[1] % m == 0

    def body(p_l, x_l):
        comm = mesh_mod.current()
        y, aux, dropped = moe_ffn(p_l, x_l, cfg, axis_name=model_axis,
                                  quantize_dispatch=quantize_dispatch,
                                  shared_sharded=shared_sharded)
        aux = comm.pmean(aux, all_axes)
        dropped = comm.pmean(dropped, all_axes)
        return y, aux, dropped

    fn = mesh_mod.shard_map(body, mesh, in_specs=(p_specs, x_spec),
                            out_specs=(x_spec, P(), P()),
                            what="moe_ffn_shard_map")
    return fn(p, x)


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
