"""Training launcher of the port: ``python -m repro_torch.launch.train --arch
<id> [--full] [--device cpu]`` (counterpart of ``repro.launch.train``).

Trains a reduced config, or the full config with ``--full``, from a
seeded random init on ``TokenPipeline`` batches, with the reference's
checkpoint cadence and restart (``--ckpt-dir``, ``--resume``; the
checkpoints are in the reference's format, so either launcher resumes
the other's).  The parser has every flag of the reference, with its
default, plus ``--device``: the run is on the card unless ``--device
cpu`` asks for the CPU; with no card the default raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, reduced_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.kernels import resolve_device
from repro_torch.train.step import make_train_state, make_train_step
from repro_torch.utils.logging import get_logger

log = get_logger("train")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true",
                    help="use the full (pod-scale) config, not the reduced")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (default: the card; "
                         "raises without one)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduced_config(cfg)
    dev = resolve_device(args.device)
    pipe = TokenPipeline(cfg, args.batch, args.seq, seed=args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = make_train_state(cfg, generator=gen, device=dev)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and args.resume:
        try:
            state, start = mgr.restore(state)
            log.info("resumed from step %d", start)
        except FileNotFoundError:
            log.info("no checkpoint found; starting fresh")

    step_fn = make_train_step(cfg, peak_lr=args.lr, warmup=20,
                              total_steps=args.steps)

    def card(a):
        return None if a is None else torch.from_numpy(a).to(dev)

    monitor = StragglerMonitor(n_hosts=1)
    losses = []
    t_last = time.time()
    for i in range(start, args.steps):
        batch = pipe.batch_at(i)
        state, metrics = step_fn(state, card(batch["tokens"]),
                                 card(batch["labels"]),
                                 frontend_inputs=card(batch.get("frontend")))
        now = time.time()
        monitor.record(0, now - t_last)
        t_last = now
        losses.append(float(metrics["loss"]))
        if i % args.log_every == 0 or i == args.steps - 1:
            log.info("step %d loss %.4f lr %.2e gnorm %.3f", i,
                     losses[-1], float(metrics["lr"]),
                     float(metrics["grad_norm"]))
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save_async(i + 1, state)
    if mgr:
        mgr.wait()
        mgr.save(args.steps, state)
    first = np.mean(losses[:10])
    last = np.mean(losses[-10:])
    log.info("loss %.4f -> %.4f (%s)", first, last,
             "IMPROVED" if last < first else "no improvement")
    return losses


if __name__ == "__main__":
    main()
