"""Pipeline parallelism over a stage axis (GPipe schedule, differentiable;
the port of ``repro.distributed.pipeline``).

Each stage is a rank (a coordinate of ``stage_axis``); activations cross
from stage to stage with ``ppermute`` once per microbatch.  Autograd
differentiates through the ppermutes (``distributed/mesh.py``: the
backward sends each cotangent to the stage before), so the same code
trains.

The schedule runs ``n_micro + n_stages - 1`` ticks; each tick every stage
processes one microbatch slot (bubble slots compute on zeros: the classic
GPipe bubble, fraction (S-1)/(M+S-1)).  The tick loop is unrolled in
Python; what depends on the stage (feeding, storing, the final mask) goes
through ``torch.where`` on the stage index, so every rank records the
same graph and its backward issues the same collectives in the same
order.

Usage (on each rank of ``mesh``, every rank passing the same global
arguments):

    fn = pipeline_apply(stage_fn, mesh, stage_axis="pod", n_micro=4)
    y = fn(stage_params, x)     # stage_params leaves: leading stage dim
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import mesh as mesh_mod
from repro_torch.distributed.mesh import P


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def pipeline_apply(stage_fn: Callable, mesh, *, stage_axis: str = "pod",
                   n_micro: int, data_axes: tuple = ("data",)):
    """Build a pipelined forward over ``stage_axis``.

    ``stage_fn(params_stage, x_micro) -> y_micro`` is one stage's compute
    (e.g. a block of layers).  ``x`` is [B, ...] with the local B
    divisible by n_micro; stage 0 feeds microbatches in, stage S-1
    collects outputs.  Returns a function (stage_params, x) -> y where
    ``stage_params`` leaves (a tensor or a nested dict) have a leading
    stage dimension; it runs on a rank of ``mesh`` and returns the global
    ``y`` on every rank.
    """
    S = mesh.shape[stage_axis]

    def body(params_st, x):
        # params_st leaves arrive as [1, ...] (this stage's block): strip
        # the stage dim; x: the data shard's batch on every stage (only
        # stage 0's copy is fed in)
        comm = mesh_mod.current()
        params_st = _map(lambda a: a[0], params_st)
        sid = torch.tensor(comm.axis_index(stage_axis), device=x.device)
        first, last = sid == 0, sid == S - 1
        B = x.shape[0]
        assert B % n_micro == 0
        mb = B // n_micro
        micro = x.reshape(n_micro, mb, *x.shape[1:])
        fwd_perm = [(i, i + 1) for i in range(S - 1)]

        buf = torch.zeros_like(micro[0])
        out = [torch.zeros_like(micro[0]) for _ in range(n_micro)]
        for t in range(n_micro + S - 1):
            # stage 0 loads microbatch t (if in range)
            feed = micro[t] if t < n_micro else torch.zeros_like(buf)
            cur = torch.where(first, feed, buf)
            y = stage_fn(params_st, cur)
            # the last stage stores its result at slot t - (S - 1)
            slot = t - (S - 1)
            if slot >= 0:
                out[slot] = torch.where(last, y, out[slot])
            buf = comm.ppermute(y, stage_axis, fwd_perm)
        out = torch.stack(out)
        # the last stage's outputs to every stage: a masked psum, so the
        # result is replicated over the pipeline axis
        out = comm.psum(torch.where(last, out, torch.zeros_like(out)),
                        stage_axis)
        return out.reshape(B, *x.shape[1:])

    dspec = data_axes if len(data_axes) != 1 else data_axes[0]

    def wrapped(stage_params, x):
        fn = mesh_mod.shard_map(body, mesh,
                                in_specs=(P(stage_axis), P(dspec)),
                                out_specs=P(dspec), what="pipeline_apply")
        return fn(stage_params, x)

    return wrapped


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
