"""Plain PyTorch version of the join kernel (same flattened contract as
``repro.kernels.stjoin.ref.stjoin_ref``)."""
from __future__ import annotations

import torch

from repro_torch.core.types import f32, sqrt_rn

# elements of one [rows, C, Mc] broadcast temporary
CHUNK_ELEMENTS = 1 << 27


def stjoin_ref(ref_x, ref_y, ref_t, ref_id, ref_ok,
               cand_x, cand_y, cand_t, cand_id, cand_ok, eps_sp, eps_t, *,
               chunk_elements: int = CHUNK_ELEMENTS):
    """Returns ``(best_w [P, C] f32, best_idx [P, C] i32)``.

    Reference points ``[P]`` against candidate trajectories ``[C, Mc]``.
    The ``[P, C, Mc]`` broadcast runs in chunks of reference points.
    """
    P = ref_x.shape[0]
    C, Mc = cand_x.shape
    dev = ref_x.device
    eps_sp, eps_t = f32(eps_sp, dev), f32(eps_t, dev)
    eps2 = eps_sp * eps_sp
    best_w = torch.empty((P, C), dtype=torch.float32, device=dev)
    best_idx = torch.empty((P, C), dtype=torch.int32, device=dev)
    rows = max(1, chunk_elements // max(C * Mc, 1))
    for p0 in range(0, P, rows):
        p = slice(p0, p0 + rows)
        dx = ref_x[p, None, None] - cand_x[None]
        dy = ref_y[p, None, None] - cand_y[None]
        dt = (ref_t[p, None, None] - cand_t[None]).abs()
        d2 = dx * dx + dy * dy
        ok = (d2 <= eps2) & (dt <= eps_t)
        ok &= ref_ok[p, None, None] & cand_ok[None]
        ok &= ref_id[p, None, None] != cand_id[None, :, None]
        w = torch.where(ok, 1.0 - sqrt_rn(d2) / eps_sp, -1.0)
        bw = w.amax(dim=-1)
        arg = w.argmax(dim=-1)
        best_w[p] = bw.clamp_min(0.0)
        best_idx[p] = torch.where(bw > 0.0, arg.to(torch.int32), -1)
    return best_w, best_idx
