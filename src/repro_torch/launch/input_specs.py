"""Shape-and-dtype stand-ins for every (arch x shape) cell (the port of
``repro.launch.input_specs``).

Every tensor here lives on ``device="meta"``: it has the reference's
``jax.eval_shape`` shape and dtype and no storage, so nothing is
allocated whatever the cell's size.
"""
from __future__ import annotations

import torch

from repro_torch.configs.registry import SHAPES, get_arch
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.train.step import TrainState, make_train_state

META = torch.device("meta")


def abstract_train_state(cfg: ModelConfig, ep_degree: int = 1) -> TrainState:
    return make_train_state(cfg, generator=None, device=META,
                            ep_degree=ep_degree)


def abstract_params(cfg: ModelConfig, ep_degree: int = 1):
    return tf.init_model(cfg, generator=None, device=META,
                         ep_degree=ep_degree)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    return tf.init_cache(cfg, batch, max_len, device=META)


def input_specs(arch: str, shape: str) -> dict:
    """Abstract model inputs for one cell.  Keys depend on the shape kind:
    train  -> tokens, labels (+ frontend)
    prefill-> tokens (+ frontend), cache
    decode -> tokens, cache, index
    """
    cfg = get_arch(arch)
    sh = SHAPES[shape]
    B, L, kind = sh["global_batch"], sh["seq_len"], sh["kind"]

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=META)

    def tok(b, l):
        if cfg.family == "audio":
            return empty(b, cfg.n_codebooks, l)
        return empty(b, l)

    out = {"cfg": cfg, "kind": kind, "batch": B, "seq": L}
    if kind == "train":
        out["tokens"] = tok(B, L)
        out["labels"] = tok(B, L)
        if cfg.family == "vlm":
            out["frontend"] = empty(B, cfg.vision_tokens, cfg.d_vision,
                                    dtype=torch.float32)
    elif kind == "prefill":
        Lt = L - (cfg.vision_tokens if cfg.family == "vlm" else 0)
        out["tokens"] = tok(B, Lt)
        out["cache"] = abstract_cache(cfg, B, L)
        if cfg.family == "vlm":
            out["frontend"] = empty(B, cfg.vision_tokens, cfg.d_vision,
                                    dtype=torch.float32)
    elif kind == "decode":
        out["tokens"] = tok(B, 1)
        out["cache"] = abstract_cache(cfg, B, L)
        out["index"] = empty()
    return out
