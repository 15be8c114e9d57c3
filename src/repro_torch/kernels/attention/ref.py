"""Plain PyTorch version of the attention forward kernel (counterpart of
``repro.kernels.attention.ref``): the masked softmax materialised.

Masked scores are ``-1e30``, so a row with every key masked returns the
mean of ``v``.  In bfloat16 the two einsums return bfloat16, as the
reference's do: the scores are rounded before the softcap, the
probabilities before the product with ``v``.
"""
from __future__ import annotations

import torch

NEG = -1e30


def attention_mask(q_positions, kv_positions, window, prefix, max_kv):
    """``[Lq, M]`` bool: causal within ``window``, or both inside the
    bidirectional prefix; and the key at or before ``max_kv``."""
    qp = q_positions.to(torch.int64)[:, None]
    kp = kv_positions.to(torch.int64)[None, :]
    causal = (kp <= qp) & (kp > qp - int(window))
    bidir = (kp < int(prefix)) & (qp < int(prefix))
    return (causal | bidir) & (kp <= int(max_kv))


def flash_attention_ref(q, k, v, q_positions, kv_positions, window, prefix,
                        max_kv, softcap=None):
    """q: [B, Lq, KV, G, hd]; k/v: [B, M, KV, hd] -> [B, Lq, KV, G, hd]."""
    s = torch.einsum("blkgh,bmkh->blkgm", q, k).to(torch.float32)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    ok = attention_mask(q_positions, kv_positions, window, prefix, max_kv)
    s = torch.where(ok[None, :, None, None, :], s,
                    torch.tensor(NEG, dtype=torch.float32, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("blkgm,bmkh->blkgh", p.to(q.dtype), v)


def kernel_tolerance(q, k, v, q_positions, kv_positions, window, prefix,
                     max_kv, softcap, want):
    """How far the kernel's output may lie from ``want``, this plain
    version's output, element by element.

    float32: ``2e-5 + 1e-4 * |want|`` (the sums run in another order).
    bfloat16: ``2**-7 * (P|v|) + 1e-2 * |want|``.  Both round every
    probability to bfloat16, the kernel before normalising (as
    ``flash.py`` does) and this version after (as ``ref.py`` does); a
    rounding is off by at most u = 2**-8 of the probability, so the two
    outputs differ by at most ``2u * sum_j p_j |v_j|`` (p normalised):
    ``P|v|`` is ``flash_attention_ref`` in float32 with ``|v|``.  ``rtol``
    covers the output's own rounding (one ulp is at most 2**-7 of it), and
    the margin a score that rounds to the neighbouring bfloat16 in one of
    the two.
    """
    want = want.float()
    if q.dtype == torch.float32:
        return 2e-5 + 1e-4 * want.abs()
    pv = flash_attention_ref(q.float(), k.float(), v.float().abs(),
                             q_positions, kv_positions, window, prefix,
                             max_kv, softcap)
    return 2.0 ** -7 * pv + 1e-2 * want.abs()
