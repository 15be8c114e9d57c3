"""Unified decoder LM covering all assigned architecture families (the
port of ``repro.models.transformer``).

Families
--------
dense   llama-style (deepseek-7b, smollm-360m, yi-6b) and gemma-2 variants
        (local/global alternation, softcaps, pre+post norms)
moe     qwen2-moe / moonlight (routed + shared experts, first-k dense)
rwkv    RWKV-6 Finch (attention-free)
hybrid  zamba2 (Mamba-2 backbone + one *shared* attention block every k)
vlm     paligemma (SigLIP-stub prefix + gemma backbone, prefix-LM mask)
audio   musicgen (EnCodec-stub: 4 codebooks summed in, 4 heads out)

The parameters keep the reference's tree: layer stacks are stacked
``[L, ...]`` leaves, and a Python loop over layer slices replaces
``lax.scan`` (the stacks are unbound once a forward, so the backward
stacks each leaf's layer gradients once).  ``remat`` wraps each layer
body as the reference's ``jax.checkpoint`` does, with
``torch.utils.checkpoint`` (``"dots"``: a selective policy that saves
the matrix products' outputs, the reference's ``dots_saveable``).
``init_model`` returns a :class:`ParamTree`, an ``nn.Module`` whose parameter names are the tree's paths joined with dots
(``layers.attn.wq``, ``embed.table``).  Caches are updated in place (slice
assignment in place of the reference's donated buffers); ``forward`` still
returns ``(logits, aux, new_cache)``, ``new_cache`` being the cache given.

``forward(mesh=, dp_axes=)`` runs on each rank of ``mesh`` (a
``distributed.mesh.Mesh`` whose ranks ``mesh.spawn`` started; outside one
it raises), every rank passing the same global arguments: each MoE block
runs its experts through ``moe.moe_ffn_shard_map`` (the batch sharded
over ``dp_axes``, the experts over 'model'), everything else runs on the
global arrays on every rank, and every rank returns the same global
result.  A family without MoE blocks runs as without a mesh.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed import mesh as mesh_mod
from repro_torch.kernels import resolve_device
from repro_torch.models import layers as Lyr
from repro_torch.models import mamba2, moe as moe_mod, rwkv6
from repro_torch.models.config import ModelConfig

GLOBAL_WINDOW = 1 << 30


class ParamTree(nn.Module):
    """A nested dict of tensors as an ``nn.Module``: a dict becomes a
    submodule, a tensor a parameter, so ``named_parameters()`` gives the
    reference tree's paths joined with dots.  ``p["attn"]`` reads a child
    as the reference's dicts do; :meth:`tree` gives the nested dict."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def __getitem__(self, key):
        return getattr(self, key)

    def tree(self) -> dict:
        out: dict[str, Any] = dict(self._parameters)
        out.update((k, m.tree()) for k, m in self._modules.items())
        return out


def _as_tree(params) -> dict:
    return params.tree() if isinstance(params, ParamTree) else params


def _unstack(tree) -> list:
    """The layers of a stacked ``[L, ...]`` tree, each leaf unbound once:
    its backward is one ``stack``, where indexing each layer apart would
    add a zero tensor of the whole stack per layer."""
    cols = {k: _unstack(v) if isinstance(v, dict) else torch.unbind(v)
            for k, v in tree.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _stack(trees: list) -> dict:
    t0 = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(t0[k], dict)
            else torch.stack([t[k] for t in trees]) for k in t0}


# --------------------------- block init -------------------------------------

def init_dense_block(cfg: ModelConfig, generator, device=None):
    p = {
        "ln1": Lyr.init_rmsnorm(cfg.d_model, device),
        "attn": Lyr.init_attention(cfg, generator, device),
        "ln2": Lyr.init_rmsnorm(cfg.d_model, device),
        "mlp": Lyr.init_mlp(cfg.d_model, cfg.d_ff, generator, device),
    }
    if cfg.gemma_norms:
        p["post_ln1"] = Lyr.init_rmsnorm(cfg.d_model, device)
        p["post_ln2"] = Lyr.init_rmsnorm(cfg.d_model, device)
    return p


def init_moe_block(cfg: ModelConfig, generator, device=None,
                   ep_degree: int = 1):
    return {
        "ln1": Lyr.init_rmsnorm(cfg.d_model, device),
        "attn": Lyr.init_attention(cfg, generator, device),
        "ln2": Lyr.init_rmsnorm(cfg.d_model, device),
        "moe": moe_mod.init_moe(cfg.d_model, cfg.moe, generator, device,
                                ep_degree),
    }


# --------------------------- block apply ------------------------------------

def dense_block(p, x, cfg, positions, window, cache=None, cache_index=None,
                prefix_len=None):
    h = Lyr.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, new_cache = Lyr.attention(
        p["attn"], h, cfg, positions, cache=cache, cache_index=cache_index,
        sliding_window=window, prefix_len=prefix_len)
    if cfg.gemma_norms:
        a = Lyr.rmsnorm(p["post_ln1"], a, cfg.norm_eps)
    x = x + a
    h = Lyr.rmsnorm(p["ln2"], x, cfg.norm_eps)
    m = Lyr.mlp(p["mlp"], h, cfg.hidden_act)
    if cfg.gemma_norms:
        m = Lyr.rmsnorm(p["post_ln2"], m, cfg.norm_eps)
    return x + m, new_cache


def moe_block(p, x, cfg, positions, cache=None, cache_index=None,
              mesh=None, dp_axes=()):
    h = Lyr.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, new_cache = Lyr.attention(
        p["attn"], h, cfg, positions, cache=cache, cache_index=cache_index)
    x = x + a
    h = Lyr.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if mesh is not None:
        m, aux, dropped = moe_mod.moe_ffn_shard_map(
            p["moe"], h, cfg.moe, mesh, dp_axes,
            quantize_dispatch=cfg.moe.quantize_dispatch)
    else:
        m, aux, dropped = moe_mod.moe_ffn(p["moe"], h, cfg.moe)
    return x + m, new_cache, aux, dropped


# --------------------------- model init -------------------------------------

def _stacked(init_fn, n):
    return _stack([init_fn() for _ in range(n)])


def init_model(cfg: ModelConfig, *, generator: torch.Generator,
               device=None, ep_degree: int = 1) -> ParamTree:
    """The reference's parameter tree (its shapes and distributions; the
    bits come from ``generator``, which lives on ``device``), on the card
    unless ``device`` says otherwise."""
    dev = resolve_device(device)
    g = generator
    n_embed = cfg.vocab_size * (cfg.n_codebooks
                                if cfg.frontend == "encodec_stub" else 1)
    params: dict[str, Any] = {
        "embed": Lyr.init_embedding(n_embed, cfg.d_model, g, dev),
        "final_norm": Lyr.init_rmsnorm(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = Lyr.init_embedding(n_embed, cfg.d_model, g, dev)
    if cfg.frontend == "siglip_stub":
        params["vision_proj"] = Lyr._dense_init(
            (cfg.d_vision, cfg.d_model), g, dev)

    if cfg.family in ("dense", "vlm", "audio"):
        params["layers"] = _stacked(
            lambda: init_dense_block(cfg, g, dev), cfg.n_layers)
    elif cfg.family == "moe":
        fk = cfg.moe.first_k_dense
        if fk:
            params["dense_layers"] = _stacked(
                lambda: init_dense_block(cfg, g, dev), fk)
        params["layers"] = _stacked(
            lambda: init_moe_block(cfg, g, dev, ep_degree),
            cfg.n_layers - fk)
    elif cfg.family == "rwkv":
        params["layers"] = _stacked(
            lambda: rwkv6.init_rwkv_block(cfg, g, dev), cfg.n_layers)
    elif cfg.family == "hybrid":
        params["layers"] = _stacked(
            lambda: mamba2.init_mamba_block(cfg, g, dev), cfg.n_layers)
        params["shared_attn"] = init_dense_block(cfg, g, dev)
    else:
        raise ValueError(cfg.family)
    return ParamTree(params)


# --------------------------- cache init -------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """KV/state caches, stacked along the layer axis, on the card unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    hd, KV = cfg.resolved_head_dim, cfg.n_kv_heads

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    if cfg.family in ("dense", "vlm", "audio"):
        return {"k": zeros(cfg.n_layers, batch, max_len, KV, hd),
                "v": zeros(cfg.n_layers, batch, max_len, KV, hd)}
    if cfg.family == "moe":
        fk = cfg.moe.first_k_dense
        c = {"k": zeros(cfg.n_layers - fk, batch, max_len, KV, hd),
             "v": zeros(cfg.n_layers - fk, batch, max_len, KV, hd)}
        if fk:
            c["dense_k"] = zeros(fk, batch, max_len, KV, hd)
            c["dense_v"] = zeros(fk, batch, max_len, KV, hd)
        return c
    if cfg.family == "rwkv":
        H = cfg.d_model // cfg.rwkv.head_dim
        K = cfg.rwkv.head_dim
        L = cfg.n_layers
        return {"shift_tm": zeros(L, batch, cfg.d_model),
                "shift_cm": zeros(L, batch, cfg.d_model),
                "wkv": zeros(L, batch, H, K, K, dt=torch.float32)}
    if cfg.family == "hybrid":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        H = d_in // s.head_dim
        conv_ch = d_in + 2 * s.d_state
        L = cfg.n_layers
        n_attn = cfg.n_layers // cfg.attn_every
        return {
            "conv": zeros(L, batch, s.d_conv - 1, conv_ch),
            "ssd": zeros(L, batch, H, s.d_state, s.head_dim,
                         dt=torch.float32),
            "k": zeros(n_attn, batch, max_len, KV, hd),
            "v": zeros(n_attn, batch, max_len, KV, hd),
        }
    raise ValueError(cfg.family)


# --------------------------- forward ----------------------------------------

def _layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer sliding-window sizes (gemma2 alternation)."""
    if cfg.local_global and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else GLOBAL_WINDOW
                for i in range(cfg.n_layers)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * cfg.n_layers
    return [GLOBAL_WINDOW] * cfg.n_layers


# the matrix products: what ``jax.checkpoint_policies.dots_saveable`` saves
# (``einsum`` and ``@`` reach these)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS and not Lyr.in_kv_step():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(body, remat):
    """remat=True: full recompute; remat="dots": save GEMM outputs and
    recompute only the cheap elementwise chain (selective checkpointing).
    Only while autograd records: without a backward there is nothing to
    save."""
    if not remat or not torch.is_grad_enabled():
        return body
    kw = {"use_reentrant": False}
    if remat == "dots":
        kw["context_fn"] = _dots_contexts
    return functools.partial(checkpoint, body, **kw)


def _kv(cache, ki: str, vi: str, i: int):
    """Layer ``i``'s k / v cache: views of the stacked cache, so the
    attention's in-place write lands in it."""
    return None if cache is None else {"k": cache[ki][i], "v": cache[vi][i]}


def forward(params, tokens, cfg: ModelConfig, *,
            positions=None, cache=None, cache_index=None,
            frontend_inputs=None, remat=False,
            mesh=None, dp_axes: tuple = (),
            prefix_len_static: Optional[int] = None):
    """Returns (logits, aux_metrics, new_cache).

    tokens: [B, L] integer — or [B, n_codebooks, L] for the audio family.
    frontend_inputs: [B, vision_tokens, d_vision] for the vlm family.
    cache/cache_index: decode mode (L is typically 1); ``cache_index`` is
    a Python int (or a 0-d tensor, read once on the host).
    mesh/dp_axes: run on a rank of ``mesh`` (module docstring).
    """
    if mesh is not None:
        mesh_mod.require(mesh, "forward(mesh=)")
    P = _as_tree(params)
    dev = tokens.device
    if cache_index is not None:
        cache_index = int(cache_index)
    aux = {"moe_aux": torch.zeros((), dtype=torch.float32, device=dev),
           "moe_dropped": torch.zeros((), dtype=torch.float32, device=dev)}

    # ---- embed ----
    if cfg.family == "audio":
        B, nq, L = tokens.shape
        offs = (torch.arange(nq, dtype=tokens.dtype, device=dev)
                * cfg.vocab_size)[None, :, None]
        x = Lyr.embed(P["embed"], tokens + offs)
        x = x.sum(dim=1)                                    # [B, L, D]
    else:
        B, L = tokens.shape
        x = Lyr.embed(P["embed"], tokens, scale_by_sqrt_d=cfg.embed_scale)

    prefix_len = None
    if cfg.family == "vlm" and frontend_inputs is not None:
        vis = Lyr._bf16(frontend_inputs) @ Lyr._bf16(P["vision_proj"])
        x = torch.cat([vis, x], dim=1)
        L = x.shape[1]
        prefix_len = cfg.vision_tokens
    elif prefix_len_static is not None:
        prefix_len = prefix_len_static

    if positions is None:
        start = 0 if cache_index is None else cache_index
        positions = start + torch.arange(L, dtype=torch.int32, device=dev)

    # ---- layer stacks ----
    if cfg.family in ("dense", "vlm", "audio"):
        body = _remat(dense_block, remat)
        layers = _unstack(P["layers"])
        for i, win in enumerate(_layer_windows(cfg)):
            x, _ = body(layers[i], x, cfg, positions, win,
                        cache=_kv(cache, "k", "v", i),
                        cache_index=cache_index, prefix_len=prefix_len)

    elif cfg.family == "moe":
        fk = cfg.moe.first_k_dense
        for i, lp in enumerate(_unstack(P["dense_layers"]) if fk else []):
            x, _ = dense_block(lp, x, cfg, positions, GLOBAL_WINDOW,
                               cache=_kv(cache, "dense_k", "dense_v", i),
                               cache_index=cache_index)
        # every moe layer checkpoints fully when remat is set, "dots" too
        body = _remat(moe_block, bool(remat))
        aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
        drop_sum = torch.zeros((), dtype=torch.float32, device=dev)
        n_moe = cfg.n_layers - fk
        for i, lp in enumerate(_unstack(P["layers"])):
            x, _, a, d = body(lp, x, cfg, positions,
                              cache=_kv(cache, "k", "v", i),
                              cache_index=cache_index, mesh=mesh,
                              dp_axes=dp_axes)
            aux_sum = aux_sum + a
            drop_sum = drop_sum + d
        aux["moe_aux"] = aux_sum / n_moe
        aux["moe_dropped"] = drop_sum / n_moe

    elif cfg.family == "rwkv":
        body = _remat(rwkv6.rwkv_block, remat)
        for i, lp in enumerate(_unstack(P["layers"])):
            st = (None if cache is None else
                  {f: cache[f][i] for f in ("shift_tm", "shift_cm", "wkv")})
            x, ns = body(lp, x, cfg, st)
            if cache is not None:
                for f, v in ns.items():
                    cache[f][i] = v

    elif cfg.family == "hybrid":
        k_every = cfg.attn_every
        n_main = (cfg.n_layers // k_every) * k_every
        # the reference checkpoints the grouped Mamba layers; the shared
        # attention block and the layers after the last group run as they
        # are
        body = _remat(mamba2.mamba_block, remat)
        for li, lp in enumerate(_unstack(P["layers"])):
            st = (None if cache is None else
                  {"conv": cache["conv"][li], "ssd": cache["ssd"][li]})
            block = body if li < n_main else mamba2.mamba_block
            x, ns = block(lp, x, cfg, st)
            if cache is not None:
                cache["conv"][li] = ns["conv"]
                cache["ssd"][li] = ns["ssd"]
            if li < n_main and (li + 1) % k_every == 0:
                x, _ = dense_block(P["shared_attn"], x, cfg, positions,
                                   GLOBAL_WINDOW,
                                   cache=_kv(cache, "k", "v",
                                             li // k_every),
                                   cache_index=cache_index)
    else:
        raise ValueError(cfg.family)

    # ---- head ----
    x = Lyr.rmsnorm(P["final_norm"], x, cfg.norm_eps)
    head = P["embed"] if cfg.tie_embeddings else P["lm_head"]
    logits = Lyr.unembed({"table": head["table"]}, x,
                         final_softcap=cfg.final_softcap)
    if cfg.family == "audio":
        logits = logits.reshape(B, logits.shape[1], cfg.n_codebooks,
                                cfg.vocab_size)
    elif cfg.family == "vlm" and frontend_inputs is not None:
        logits = logits[:, cfg.vision_tokens:]
    return logits, aux, cache


def lm_loss(logits, labels, mask=None):
    """Cross entropy; labels [B, L] (or [B, nq, L] for the audio family)."""
    if logits.ndim == 4:       # audio: [B, L, nq, V], labels [B, nq, L]
        labels = torch.movedim(labels, 1, 2)
        if mask is not None and mask.ndim == 3:
            mask = torch.movedim(mask, 1, 2)
    lp = F.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.take_along_dim(lp, labels[..., None].long(), dim=-1)[..., 0]
    if mask is None:
        mask = torch.ones(ll.shape, dtype=torch.float32, device=ll.device)
    else:
        while mask.ndim < ll.ndim:
            mask = mask[..., None]
        mask = torch.broadcast_to(mask, ll.shape).to(torch.float32)
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
