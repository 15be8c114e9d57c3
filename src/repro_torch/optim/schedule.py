"""Learning-rate schedules (the port of ``repro.optim.schedule``).

``step`` is a 0-d integer tensor (the optimizer's step, on its device) and
the result a 0-d f32 tensor there, computed in the reference's order of
operations, so no host sync is needed.
"""
from __future__ import annotations

import math

import torch


def linear_warmup(step, warmup_steps: int, peak: float):
    return peak * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, warmup_steps: int, total_steps: int, peak: float,
                    floor_frac: float = 0.1):
    warm = linear_warmup(step, warmup_steps, peak)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac)
                  * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
