#!/usr/bin/env python3
"""Where one LM training step of the port spends its time on one CUDA
card:

    python3 tools/lm_train_profile.py [--arch smollm-360m] [--batch 4]
                                      [--seq 4096] [--remat true]

Full width, a seeded init, ``TokenPipeline`` batches.  After two warm
steps it times one step in parts with CUDA events: the forward and the
loss (autograd recording), the backward (``torch.autograd.grad``, the
remat recompute included), the clip and AdamW; and, inside the forward
(not the backward's recompute), every ``layers._attend_online`` call (the online softmax over the KV
chunks) and the head (``layers.unembed`` and ``lm_loss``).  Then one
more step under ``torch.profiler`` (CPU and CUDA activity): the device's
busy share of the step's wall (the union of kernel intervals), the
kernel launches, and the ten kernels with the most device time.
Prints the card's name and power limit beside the numbers.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "?"


class Timed:
    """CUDA events around every call of ``mod.name`` while active."""

    def __init__(self, mod, name: str):
        self.mod, self.name, self.real = mod, name, getattr(mod, name)
        self.events = []

    def __enter__(self):
        def wrapped(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.real(*a, **kw)
            e.record()
            self.events.append((s, e))
            return out
        setattr(self.mod, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def busy_ms(events) -> tuple[float, int]:
    """The union of the kernels' device intervals (ms) and their count."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3, len(spans)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--remat", default="true",
                    choices=["true", "false", "dots"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lm_train_profile: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import layers, transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep

    remat = {"true": True, "false": False, "dots": "dots"}[args.remat]
    dev = torch.device("cuda")
    card = card_line()
    cfg = get_arch(args.arch)
    state = tstep.make_train_state(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    pipe = TokenPipeline(cfg, args.batch, args.seq, seed=0)
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=10_000)

    def batch(i):
        b = pipe.batch_at(i)
        fe = b.get("frontend")
        return (torch.from_numpy(b["tokens"]).to(dev),
                torch.from_numpy(b["labels"]).to(dev),
                None if fe is None else torch.from_numpy(fe).to(dev))

    for i in range(2):
        tok, lab, fe = batch(i)
        state, _ = tstep.train_step(state, tok, lab, cfg, frontend_inputs=fe,
                                    remat=remat, **kw)
    torch.cuda.synchronize()

    # one step in parts
    tok, lab, fe = batch(2)
    leaves = adamw.tree_leaves(state.params)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    t0 = time.perf_counter()
    ev[0].record()
    with Timed(layers, "_attend_online") as att, \
            Timed(layers, "unembed") as head, Timed(tf, "lm_loss") as loss_t:
        with torch.enable_grad():
            loss, _ = tstep._loss(state.params, tok, lab, cfg, fe, remat)
    ev[1].record()
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    ev[2].record()
    tree = state.params.tree()
    grads = tstep._unflatten(tree, list(grads))
    grads, _ = adamw.clip_by_global_norm(grads, 1.0)
    from repro_torch.optim.schedule import cosine_schedule
    lr = cosine_schedule(state.opt.step, kw["warmup"], kw["total_steps"],
                         kw["peak_lr"])
    _, opt = adamw.adamw_update(grads, state.opt, state.params, lr=lr)
    state = tstep.TrainState(state.params, opt)
    ev[3].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    fwd, bwd, opt = (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                     ev[2].elapsed_time(ev[3]))
    print(f"{args.arch} B {args.batch} x L {args.seq}, remat={remat!r} "
          f"({card}; torch {torch.__version__}): step {fwd + bwd + opt:.1f} "
          f"ms (host wall {wall:.1f}): forward and loss {fwd:.1f}, backward "
          f"{bwd:.1f}, clip and AdamW {opt:.1f}; inside the forward: online "
          f"attention {att.ms():.1f} ms over {len(att.events)} calls, the "
          f"head (unembed {head.ms():.1f}, lm_loss {loss_t.ms():.1f}); "
          f"loss {float(loss.detach()):.4f}")
    del grads

    # one step under the profiler
    from torch.profiler import ProfilerActivity, profile
    tok, lab, fe = batch(3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = tstep.train_step(state, tok, lab, cfg, frontend_inputs=fe,
                                    remat=remat, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    busy, n = busy_ms(events)
    print(f"profiled step: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({busy / wall:.1%}; idle {1 - busy / wall:.1%}), {n} kernels")
    kernels = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, c = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    for name, (t, c) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {t / 1e3:9.1f} ms  {c:7d} x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
