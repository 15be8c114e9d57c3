"""AdamW as transforms over parameter trees (the port of
``repro.optim.adamw``).

Moments are kept in f32 regardless of the parameter dtype, with the tree
of the parameters (nested dicts of tensors; a ``ParamTree`` reads as its
nested dict).  Leaves are taken in the reference's ``jax.tree.leaves``
order (dict keys sorted), so the global norm sums them as it does.

``adamw_update`` writes the new parameters and moments into the given
tensors, in place and under ``torch.no_grad()``: the stand-in for the
reference's donated buffers (``train/step.py``).  Each leaf is computed
with the reference's operations in its order (``torch._foreach_*`` over
the leaves).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.checkpoint.checkpointer import (_flatten_with_paths,
                                                 _unflatten, tree_node)

F32 = torch.float32


def _tree(t):
    return t.tree() if hasattr(t, "tree") else t


def tree_leaves(tree) -> list:
    """The leaves of a tree in the reference's order."""
    return _flatten_with_paths(_tree(tree))[1]


@tree_node
@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor      # 0-d int32, on the parameters' device
    mu: Any
    nu: Any


def adamw_init(params) -> AdamWState:
    tree = _tree(params)
    leaves = tree_leaves(tree)
    dev = leaves[0].device if leaves else None

    def zeros():
        return _unflatten(tree, [torch.zeros(p.shape, dtype=F32,
                                             device=p.device)
                                 for p in leaves])
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros(), nu=zeros())


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before scaling); the squared norms add in the reference's leaf order."""
    tree = _tree(grads)
    leaves = tree_leaves(tree)
    gnorm = 0
    for g in leaves:
        gnorm = gnorm + torch.sum(torch.square(g.to(F32)))
    gnorm = torch.sqrt(torch.as_tensor(gnorm, dtype=F32))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return _unflatten(tree, [(g * scale).to(g.dtype) for g in leaves]), gnorm


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    """One AdamW step; returns ``(params, new_state)``.  ``params`` and the
    moments are the given tensors, updated in place."""
    step = state.step + 1
    t = step.to(F32)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    lr = torch.as_tensor(lr, dtype=F32, device=step.device)

    g = [x.to(F32) for x in tree_leaves(grads)]
    m = tree_leaves(state.mu)
    v = tree_leaves(state.nu)
    p = tree_leaves(params)
    if not (len(g) == len(m) == len(v) == len(p)):
        raise ValueError(f"trees differ: {len(g)} grads, {len(m)} / "
                         f"{len(v)} moments, {len(p)} params")
    # two scratch lists of leaf size, reused (about 2x the params' bytes)
    # m = b1 * m + (1 - b1) * g
    tmp = torch._foreach_mul(g, 1 - b1)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, tmp)
    # v = b2 * v + (1 - b2) * g * g
    torch._foreach_copy_(tmp, g)
    torch._foreach_mul_(tmp, 1 - b2)
    torch._foreach_mul_(tmp, g)
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, tmp)
    # delta = (m / c1) / (sqrt(v / c2) + eps) + weight_decay * p
    torch._foreach_copy_(tmp, v)
    torch._foreach_div_(tmp, c2)
    torch._foreach_sqrt_(tmp)
    torch._foreach_add_(tmp, eps)
    delta = torch._foreach_div(m, c1)
    torch._foreach_div_(delta, tmp)
    torch._foreach_copy_(tmp, p)
    torch._foreach_mul_(tmp, weight_decay)
    torch._foreach_add_(delta, tmp)
    del tmp
    # p = p - lr * delta
    torch._foreach_mul_(delta, lr)
    f32 = [i for i, x in enumerate(p) if x.dtype == F32]
    if f32:
        torch._foreach_sub_([p[i] for i in f32], [delta[i] for i in f32])
    for i, x in enumerate(p):
        if x.dtype != F32:
            x.copy_(x.to(F32) - delta[i])
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
