"""Parameters between the reference and the port.

``params_from_reference`` loads the reference's ``init_model`` tree, as
``jax.tree.map(np.asarray, params)`` gives it (nested dicts of numpy
arrays), into the port's :class:`~repro_torch.models.transformer.ParamTree`;
``params_to_numpy`` reads a ``ParamTree`` back into that form.  The round
trip is bitwise, so both packages can run on the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import ParamTree, init_model


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_shapes(v, path + "."))
        else:
            out[path] = tuple(v.shape)
    return out


def params_from_reference(tree: dict, cfg: ModelConfig, device=None,
                          ep_degree: int = 1) -> ParamTree:
    """The reference's parameter tree for ``cfg`` (experts padded to a
    multiple of ``ep_degree``, as its ``init_model(ep_degree=)`` pads
    them) as a ``ParamTree`` on ``device`` (the card unless it says
    otherwise).  Raises ``ValueError`` when the tree's paths or shapes are
    not those of ``cfg``."""
    dev = resolve_device(device)
    want = _shapes(init_model(cfg, generator=None, device="meta",
                              ep_degree=ep_degree).tree())
    got = _shapes(tree)
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"the tree is not {cfg.name}'s: {diff[:8]}")

    def load(t):
        return {k: load(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v, copy=True)).to(dev)
                for k, v in t.items()}

    return ParamTree(load(tree))


def params_to_numpy(params: ParamTree) -> dict:
    """The parameters as nested dicts of numpy arrays (host copies)."""
    def read(t):
        return {k: read(v) if isinstance(v, dict)
                else v.detach().cpu().numpy() for k, v in t.items()}
    return read(params.tree())
