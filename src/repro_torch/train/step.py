"""The training step: loss -> grads -> clip -> AdamW (the port of
``repro.train.step``).

``train_step`` runs eagerly (no ``torch.compile``): autograd takes the
gradients of the reference's masked loss, and AdamW writes the new
parameters and moments into the state's tensors in place, the stand-in
for the reference's donated buffers.  The metrics stay tensors on the
state's device: the step reads none of them back to the host.

With ``mesh=`` the step runs on each rank of the mesh (``forward(mesh=)``:
every rank passes the same global state and batch); autograd through the
mesh's collectives gives every rank the gradient of the global loss (the
MoE aux computed per data shard, then ``pmean``'d, as the reference's),
so every rank ends the step with the same state.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.checkpoint.checkpointer import _unflatten, tree_node
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, tree_leaves)
from repro_torch.optim.schedule import cosine_schedule

GSPMD_NOT_PORTED = (
    "in_shardings / out_shardings are GSPMD placements for jax.jit; only "
    "the JAX package's dry-run (launch/dryrun.py) passes them, and the "
    "port has no dry-run (JAX-only, ROADMAP): run the step on the ranks "
    "of a mesh with mesh= and dp_axes= instead")


@tree_node
@dataclasses.dataclass
class TrainState:
    params: Any             # a ParamTree
    opt: AdamWState


def make_train_state(cfg: ModelConfig, *, generator: torch.Generator,
                     device=None, ep_degree: int = 1) -> TrainState:
    """A seeded init (``generator`` lives on ``device``) and zero moments,
    on the card unless ``device`` says otherwise."""
    params = tf.init_model(cfg, generator=generator, device=device,
                           ep_degree=ep_degree)
    return TrainState(params=params, opt=adamw_init(params))


def _loss(params, tokens, labels, cfg, frontend_inputs, remat, mesh,
          dp_axes):
    logits, aux, _ = tf.forward(params, tokens, cfg,
                                frontend_inputs=frontend_inputs, remat=remat,
                                mesh=mesh, dp_axes=dp_axes)
    mask = (labels >= 0).to(torch.float32)
    loss = tf.lm_loss(logits, torch.clamp(labels, min=0), mask)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux["moe_aux"]
    return loss, aux


def loss_and_grads(params, tokens, labels, cfg: ModelConfig, *,
                   frontend_inputs=None, remat=True, mesh=None,
                   dp_axes: tuple = ()):
    """``(loss, aux, grads)``: the masked loss and its gradient tree (the
    params' nested dict; a parameter the loss does not reach gets
    zeros, as under ``jax.grad``)."""
    tree = params.tree() if hasattr(params, "tree") else params
    leaves = tree_leaves(tree)
    with torch.enable_grad():
        loss, aux = _loss(params, tokens, labels, cfg, frontend_inputs,
                          remat, mesh, dp_axes)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), aux, _unflatten(tree, list(grads))


def train_step(state: TrainState, tokens, labels, cfg: ModelConfig, *,
               frontend_inputs=None, mesh=None, dp_axes: tuple = (),
               peak_lr: float = 3e-4, warmup: int = 200,
               total_steps: int = 10_000, grad_clip: float = 1.0,
               remat=True):
    """One optimizer step; returns (new_state, metrics).  The new state
    holds the given parameter and moment tensors, updated in place."""
    loss, aux, grads = loss_and_grads(state.params, tokens, labels, cfg,
                                      frontend_inputs=frontend_inputs,
                                      remat=remat, mesh=mesh,
                                      dp_axes=dp_axes)
    grads, gnorm = clip_by_global_norm(grads, grad_clip)
    lr = cosine_schedule(state.opt.step, warmup, total_steps, peak_lr)
    new_params, new_opt = adamw_update(grads, state.opt, state.params, lr=lr)
    metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
               "moe_aux": aux["moe_aux"].detach(),
               "moe_dropped": aux["moe_dropped"].detach()}
    return TrainState(params=new_params, opt=new_opt), metrics


def make_train_step(cfg: ModelConfig, mesh=None, dp_axes: tuple = (),
                    in_shardings=None, out_shardings=None, **kw):
    """``make_jitted_train_step``'s counterpart: ``train_step`` bound to
    ``cfg``, ``mesh``, ``dp_axes`` and ``kw`` (eager; GSPMD shardings
    raise)."""
    if in_shardings is not None or out_shardings is not None:
        raise NotImplementedError(GSPMD_NOT_PORTED)
    fn = functools.partial(train_step, cfg=cfg, mesh=mesh, dp_axes=dp_axes,
                           **kw)

    def step(state, tokens, labels, frontend_inputs=None):
        return fn(state, tokens, labels, frontend_inputs=frontend_inputs)
    return step
