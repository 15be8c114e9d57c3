"""Serving: prefill / decode steps and a wave-based batched-request engine
(the port of ``repro.serve.engine``).

``ServeEngine`` batches requests into *waves*: up to ``n_slots`` queued
requests are admitted together (prompts right-padded to the wave maximum),
prefilled in one call, then decoded in lockstep with per-request stop
bookkeeping; the next wave starts when the wave drains.  Wave formation
sorts the queue by prompt length (stable), so padding waste is minimized
the way the temporal histogram equalizes partition sizes.  As in the
reference, a shorter prompt's decode attends to its wave's pad keys.

The steps run without autograd and update the cache in place (the
reference donates it); they return the same cache.  Sampling is the
reference's numpy sampler with the same seed, so both packages pick the
same token from the same logits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig


@torch.no_grad()
def prefill_step(params, tokens, cache, cfg: ModelConfig, *,
                 frontend_inputs=None, mesh=None, dp_axes: tuple = (),
                 last_positions=None):
    """Fill the cache with full prompts; returns (last_logits, cache).
    ``last_positions`` ([B] integer): per-request true last index
    (right-padded prompts); defaults to the final position for all."""
    logits, _, cache = tf.forward(
        params, tokens, cfg, cache=cache, cache_index=0,
        frontend_inputs=frontend_inputs, mesh=mesh, dp_axes=dp_axes)
    if last_positions is None:
        return logits[:, -1], cache
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, last_positions.long()], cache


@torch.no_grad()
def decode_step(params, tokens, cache, index, cfg: ModelConfig, *,
                mesh=None, dp_axes: tuple = ()):
    """One token for every sequence in the batch; returns (logits, cache)."""
    logits, _, cache = tf.forward(
        params, tokens, cfg, cache=cache, cache_index=index,
        mesh=mesh, dp_axes=dp_axes)
    return logits[:, -1], cache


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [L] int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Wave-based batched serving (a host loop around the steps) on the
    device that holds ``params``."""

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int,
                 max_len: int, temperature: float = 0.0, seed: int = 0,
                 eos_id: Optional[int] = None):
        self.params = params
        self.cfg = cfg
        self.device = next(iter(params.parameters())).device
        self.n_slots = n_slots
        self.max_len = max_len
        self.temperature = temperature
        self.eos_id = eos_id
        self.rng = np.random.default_rng(seed)
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self.decode_steps = 0
        self.prefill_calls = 0
        self.padding_waste = 0.0

    def submit(self, req: Request):
        self.queue.append(req)

    def _sample(self, logits):
        if self.temperature <= 0:
            return int(np.argmax(logits))
        p = np.exp((logits - logits.max()) / self.temperature)
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def _run_wave(self, wave: list[Request]):
        B = self.n_slots
        Lmax = max(len(r.prompt) for r in wave)
        tokens = np.zeros((B, Lmax), np.int32)
        lens = np.zeros(B, np.int64)
        for i, r in enumerate(wave):
            tokens[i, :len(r.prompt)] = r.prompt
            lens[i] = len(r.prompt)
        self.padding_waste += float(1.0 - lens[:len(wave)].sum()
                                    / (len(wave) * Lmax))
        cache = tf.init_cache(self.cfg, B, self.max_len, device=self.device)
        logits, cache = prefill_step(
            self.params, torch.from_numpy(tokens).to(self.device), cache,
            self.cfg, last_positions=torch.from_numpy(
                np.maximum(lens - 1, 0)).to(self.device))
        self.prefill_calls += 1
        logits = logits.float().cpu().numpy()
        cur = np.zeros(B, np.int32)
        for i, r in enumerate(wave):
            cur[i] = self._sample(logits[i])
            r.out.append(int(cur[i]))
        pos = int(Lmax)
        alive = {i for i, r in enumerate(wave) if r.max_new > 1}
        while alive and pos < self.max_len - 1:
            logits, cache = decode_step(
                self.params, torch.from_numpy(cur[:, None]).to(self.device),
                cache, pos, self.cfg)
            self.decode_steps += 1
            logits = logits.float().cpu().numpy()
            for i in list(alive):
                r = wave[i]
                tok = self._sample(logits[i])
                r.out.append(tok)
                cur[i] = tok
                if (len(r.out) >= r.max_new
                        or (self.eos_id is not None and tok == self.eos_id)):
                    alive.discard(i)
            pos += 1
        for r in wave:
            r.done = True
            self.completed.append(r)

    def run(self):
        """Drain the queue wave by wave."""
        self.queue.sort(key=lambda r: len(r.prompt))
        while self.queue:
            wave = [self.queue.pop(0)
                    for _ in range(min(self.n_slots, len(self.queue)))]
            self._run_wave(wave)
        return self.completed
