"""Deterministic, restart-safe synthetic token pipeline with prefetch (the
port's copy of ``repro.data.pipeline``: pure numpy, batches bitwise the
reference's).

``TokenPipeline`` is seed+step-indexed: batch(i) is a pure function of
(seed, i), so resuming from a checkpoint at step i reproduces the exact
stream at ANY world size (elasticity requirement).  A double-buffer thread
overlaps host batch synthesis with device compute.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


class TokenPipeline:
    """Markov-chain synthetic corpus (learnable structure, not noise)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0, order: int = 2):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        V = min(cfg.vocab_size, 512)
        rng = np.random.default_rng(seed)
        # sparse-ish transition structure so the LM has something to learn
        self.next_tok = rng.integers(0, V, (V, 8))
        self.V = V

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        B, L = self.batch, self.seq_len
        toks = np.zeros((B, L + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.V, B)
        choices = rng.integers(0, 8, (B, L))
        noise = rng.uniform(0, 1, (B, L)) < 0.05
        rand = rng.integers(0, self.V, (B, L))
        for t in range(L):
            nxt = self.next_tok[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.family == "audio":
            nq = self.cfg.n_codebooks
            out = {"tokens": np.repeat(out["tokens"][:, None], nq, 1),
                   "labels": np.repeat(out["labels"][:, None], nq, 1)}
        if self.cfg.family == "vlm":
            out["frontend"] = rng.normal(
                0, 1, (B, self.cfg.vision_tokens,
                       self.cfg.d_vision)).astype(np.float32)
        return out

    def iterate(self, start_step: int = 0,
                prefetch: int = 2) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            i = start_step
            while not stop.is_set():
                q.put(self.batch_at(i))
                i += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
