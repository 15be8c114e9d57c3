"""Serving launcher of the port: ``python -m repro_torch.launch.serve --arch
<id> [--full] [--device cpu]`` (counterpart of ``repro.launch.serve``).

Runs the wave-batched ServeEngine over synthetic requests on a reduced
config, or on the full config with ``--full``; the weights are a seeded
random init.  The parser has every flag of the reference, with its
default, plus ``--device``: the run is on the card unless ``--device cpu``
asks for the CPU; with no card the default raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced_config
from repro_torch.kernels import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.utils.logging import get_logger

log = get_logger("serve")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (default: the card; raises "
                         "without one)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduced_config(cfg)
    if cfg.family == "audio":
        raise SystemExit("audio decode is exercised by the dry-run "
                         "(multi-codebook prompts need the EnCodec stub); "
                         "pick a text arch for the serving demo")
    if cfg.family in ("vlm",):
        log.warning("vlm serving demo uses text-only prompts")

    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = tf.init_model(cfg, generator=gen, device=dev)
    engine = ServeEngine(params, cfg, n_slots=args.slots,
                         max_len=args.max_len)
    rng = np.random.default_rng(args.seed)
    for uid in range(args.requests):
        L = int(rng.integers(args.prompt_len // 2, args.prompt_len + 1))
        prompt = rng.integers(0, cfg.vocab_size, L).astype(np.int32)
        engine.submit(Request(uid=uid, prompt=prompt, max_new=args.max_new))

    t0 = time.time()
    done = engine.run()
    dt = time.time() - t0
    total_new = sum(len(r.out) for r in done)
    log.info("served %d requests, %d tokens in %.2fs (%.1f tok/s); "
             "%d decode steps, %d prefill calls, padding waste %.2f",
             len(done), total_new, dt, total_new / max(dt, 1e-9),
             engine.decode_steps, engine.prefill_calls,
             engine.padding_waste / max(engine.prefill_calls, 1))
    return done


if __name__ == "__main__":
    main()
