"""Partitioning rules: parameter / optimizer / activation specs (the port
of ``repro.distributed.partition``).

Policy (TP over 'model', DP over ('pod','data'), optional ZeRO/FSDP over
'data'):

  embeddings / lm head   [V, D]      -> (model, None)        vocab-sharded
  attn q proj            [D, H, hd]  -> (None, model, None)  head-sharded
  attn kv projs          [D, KV, hd] -> (None, model, None)  if KV % m == 0
  attn out proj          [H, hd, D]  -> (model, None, None)
  mlp in projs           [D, F]      -> (None, model)
  mlp out proj           [F, D]      -> (model, None)
  MoE expert weights     [E, D, F]   -> (model, None, None)  EP
  MoE router / norms / small vectors -> replicated
  rwkv square projs      [D, D]      -> (None, model) in / (model, None) out
  mamba in_proj/conv     replicated (interleaved head layout); out_proj
                         [d_in, D]  -> (model, None)

A dimension is sharded only when divisible by the axis size; otherwise the
leaf silently falls back to replication (surfaced by ``report_sharding``).
Stacked (layer-stack) parameters get a leading ``None``.  Optimizer
moments reuse the same rule.

A spec is a :class:`PartitionSpec` (``distributed/mesh.py``, the layer
below, with ``local_block``; re-exported here): one entry a dimension,
``None``, an axis name or a tuple of names.  The reference hands its specs to GSPMD;
here their one use is to give each rank its block of a global array
(``local_block``, :class:`NamedSharding`, ``distributed/mesh.py::
shard_map``).  The functions take parameter trees (nested dicts of
tensors, a ``ParamTree``, or the ``device="meta"`` trees of
``launch/input_specs.py``) and anything with a ``.shape`` dict as the
mesh.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any

from repro_torch.distributed.mesh import P, PartitionSpec, local_block

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``'s record: a mesh and a spec."""
    mesh: Any
    spec: PartitionSpec

    def local_block(self, x, comm):
        return local_block(x, self.spec, comm)


def _tree(params) -> dict:
    return params.tree() if hasattr(params, "tree") else params


def _map_with_path(fn, tree, prefix=""):
    return {k: (_map_with_path(fn, v, f"{prefix}{k}/")
                if isinstance(v, dict) else fn(f"{prefix}{k}", v))
            for k, v in _tree(tree).items()}


def _leaves(tree) -> list:
    out = []
    for v in _tree(tree).values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _rule(name: str, shape: tuple[int, ...], m: int,
          fsdp_axis=None, fsdp: int = 1):
    """Base spec (without the stacked leading axis)."""
    def div(i, n=m):
        return shape[i] % n == 0

    leaf = name.split("/")[-1]
    parent = name.split("/")[-2] if "/" in name else ""

    if parent in ("embed", "lm_head") and leaf == "table":
        return P("model", None) if div(0) else P()
    if leaf == "vision_proj":
        return P(None, "model") if div(1) else P()
    if parent == "attn":
        if leaf == "wq":
            return P(None, "model", None) if div(1) else P()
        if leaf in ("wk", "wv"):
            return P(None, "model", None) if div(1) else P()
        if leaf == "wo":
            return P("model", None, None) if div(0) else P()
    if parent == "mlp":
        if leaf in ("wi_gate", "wi_up"):
            return P(None, "model") if div(1) else P()
        if leaf == "wo":
            return P("model", None) if div(0) else P()
    if parent == "moe":
        if leaf in ("w_gate", "w_up", "w_down"):
            return P("model", None, None) if div(0) else P()
        if leaf in ("ws_gate", "ws_up"):
            return P(None, "model") if div(1) else P()
        if leaf == "ws_down":
            return P("model", None) if div(0) else P()
        return P()   # router + misc
    # rwkv
    if leaf in ("wr", "wk", "wv", "wg", "cm_k", "cm_r") and len(shape) == 2:
        return P(None, "model") if div(1) else P()
    if leaf in ("wo", "cm_v") and len(shape) == 2:
        return P("model", None) if div(0) else P()
    # mamba
    if leaf == "out_proj":
        return P("model", None) if div(0) else P()
    if leaf == "in_proj":
        return P()
    return P()


def param_specs(params, cfg, mesh, *, fsdp: bool = False,
                policy: str = "tp"):
    """A spec tree matching ``params`` (nested dicts, "/" paths).

    policy="tp"      : tensor parallel over 'model' (default, rules above)
    policy="dp_only" : no tensor parallelism: parameters replicated, the
                       'model' axis is extra data parallelism.
    policy="dp_fsdp" : parameters sharded over 'model' then 'data' on
                       their largest dividing dimension.
    """
    m = mesh.shape.get("model", 1)
    d = mesh.shape.get("data", 1)

    def one(name, leaf):
        stacked = name.startswith(("layers/", "dense_layers/"))
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        if policy == "dp_only":
            parts = [None] * len(shape)
        elif policy == "dp_fsdp":
            parts = [None] * len(shape)
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            for ax_name, ax_size in (("model", m), ("data", d)):
                for i in order:
                    if (parts[i] is None and ax_size > 1
                            and shape[i] % ax_size == 0
                            and shape[i] >= ax_size):
                        parts[i] = ax_name
                        break
        else:
            parts = list(_rule(name, shape, m))
            while len(parts) < len(shape):
                parts.append(None)
            if fsdp and d > 1:
                # ZeRO-3-style: additionally shard the largest unsharded dim
                for i, pp in enumerate(parts):
                    if pp is None and shape[i] % d == 0 and shape[i] >= d * 8:
                        parts[i] = "data"
                        break
        if stacked:
            parts = [None] + parts
        return P(*parts)

    return _map_with_path(one, params)


def named(mesh, spec_tree):
    """The :class:`NamedSharding` of every spec in ``spec_tree``."""
    if isinstance(spec_tree, PartitionSpec):
        return NamedSharding(mesh, spec_tree)
    return {k: named(mesh, v) for k, v in spec_tree.items()}


def report_sharding(params, specs) -> dict:
    """Bytes sharded vs replicated: surfaces silent replication fallbacks."""
    total = 0
    replicated = 0
    for leaf, spec in zip(_leaves(params), _leaves(specs)):
        nbytes = math.prod(leaf.shape) * leaf.element_size()
        total += nbytes
        if all(s is None for s in spec):
            replicated += nbytes
    return {"total_bytes": total, "replicated_bytes": replicated,
            "replicated_frac": replicated / max(total, 1)}


# --------------------------- activation specs --------------------------------

def batch_spec(mesh) -> PartitionSpec:
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return P(dp if len(dp) > 1 else dp[0] if dp else None)


def data_specs(cfg, mesh, *, kind: str, global_batch: int, seq_len: int,
               policy: str = "tp"):
    """Input/cache specs for a (shape kind, arch) cell."""
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if policy in ("dp_only", "dp_fsdp"):
        dp_axes = dp_axes + tuple(
            a for a in ("model",) if a in mesh.shape)
    dp = math.prod(mesh.shape[a] for a in dp_axes) if dp_axes else 1
    m = mesh.shape.get("model", 1)
    bspec = dp_axes if global_batch % max(dp, 1) == 0 and dp > 1 else None
    if bspec is None and dp > 1 and global_batch > 1:
        # surfaced, not silent: a replicated batch means every device
        # computes the full global batch
        warnings.warn(
            f"global_batch={global_batch} does not divide the data-parallel "
            f"degree {dp} ({dp_axes}); batch will be REPLICATED on every "
            "device — compute will not scale", stacklevel=2)
    if isinstance(bspec, tuple) and len(bspec) == 1:
        bspec = bspec[0]

    if cfg.family == "audio":
        tok = P(bspec, None, None)
    else:
        tok = P(bspec, None)

    specs = {"tokens": tok}
    if cfg.family == "vlm":
        specs["frontend"] = P(bspec, None, None)
    if kind == "train":
        specs["labels"] = tok
        return specs

    # decode: cache specs
    seq_axis = None
    if bspec is None and "data" in mesh.shape and seq_len % mesh.shape[
            "data"] == 0:
        seq_axis = "data"       # long-context: shard the KV cache sequence
    kv_ax = ("model" if cfg.n_kv_heads % m == 0 and m > 1
             and policy == "tp" else None)

    cache = {}
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        cache["k"] = P(None, bspec, seq_axis, kv_ax, None)
        cache["v"] = P(None, bspec, seq_axis, kv_ax, None)
        if cfg.family == "moe" and cfg.moe.first_k_dense:
            cache["dense_k"] = cache["k"]
            cache["dense_v"] = cache["v"]
    if cfg.family == "rwkv":
        h_ax = ("model" if (cfg.d_model // cfg.rwkv.head_dim) % m == 0
                and policy == "tp" else None)
        cache["shift_tm"] = P(None, bspec, None)
        cache["shift_cm"] = P(None, bspec, None)
        cache["wkv"] = P(None, bspec, h_ax, None, None)
    if cfg.family == "hybrid":
        s = cfg.ssm
        h = (s.expand * cfg.d_model) // s.head_dim
        h_ax = "model" if h % m == 0 and policy == "tp" else None
        cache["conv"] = P(None, bspec, None, None)
        cache["ssd"] = P(None, bspec, h_ax, None, None)
        cache["k"] = P(None, bspec, seq_axis, kv_ax, None)
        cache["v"] = P(None, bspec, seq_axis, kv_ax, None)
    specs["cache"] = cache
    return specs
