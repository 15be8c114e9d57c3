"""Plain PyTorch versions of the attention forward kernels (counterpart of
``repro.kernels.attention.ref``): the masked softmax materialised.

Masked scores are ``-1e30``, so a row with every key masked returns the
mean of ``v``.  In bfloat16 the two einsums return bfloat16, as the
reference's do: the scores are rounded before the softcap, the
probabilities before the product with ``v``.

Beside the oracle, the plain mirrors of two pieces of the CUDA launcher
(``csrc/attention_kernels.cu``): the tile test that decides which (row
block, key tile) pairs it skips (``tile_class_ref``), and the key split
with its merge pass (``split_partials_ref``, ``merge_partials_ref``).
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


def _block_range(pos, size, n):
    """Min and max of ``pos`` over consecutive blocks of ``size``, padded
    with the last element (which does not move a block's range)."""
    nb = -(-n // size)
    pad = pos[-1:].expand(nb * size - n)
    blocks = torch.cat([pos, pad]).view(nb, size)
    return blocks.amin(1), blocks.amax(1)


def tile_class_ref(q_positions, kv_positions, window, prefix, max_kv, *, G,
                   rows, keys):
    """``[row blocks, key tiles]`` int: 0 where every (row, key) pair of the
    block and tile is masked (the kernels skip it), 2 where every pair is
    kept (no per-element mask), 1 otherwise; the interval test of
    ``attention_kernels.cu::tile_class`` over each block's min / max query
    position (row ``r`` is query ``r // G``) and each tile's min / max key
    position.  A tile that reaches past the last key is never 2."""
    qp = q_positions.to(torch.int64).repeat_interleave(G)
    kp = kv_positions.to(torch.int64)
    qmin, qmax = (x[:, None] for x in _block_range(qp, rows, qp.numel()))
    kmin, kmax = (x[None, :] for x in _block_range(kp, keys, kp.numel()))
    window, prefix, max_kv = int(window), int(prefix), int(max_kv)
    causal = (kmin <= qmax) & (kmax > qmin - window)
    bidir = (kmin < prefix) & (qmin < prefix)
    masked = (kmin > max_kv) | ~(causal | bidir)
    full = (kmax <= max_kv) & (((kmax <= qmin) & (kmin > qmax - window))
                               | ((kmax < prefix) & (qmax < prefix)))
    whole = torch.ones_like(kmin, dtype=torch.bool)
    if kp.numel() % keys:
        whole[0, -1] = False
    return torch.where(masked, 0, torch.where(full & whole, 2, 1))


def split_partials_ref(q, k, v, q_positions, kv_positions, window, prefix,
                       max_kv, softcap, bounds):
    """Each key split's float32 ``(m, l, acc)``, stacked on a leading axis,
    as the kernels write them for keys ``bounds[s] = (k0, k1)``: ``m`` the
    max masked score (at least ``-1e30``), ``l`` the sum of ``exp(s - m)``,
    ``acc`` those probabilities (rounded to ``q``'s dtype) times ``v``."""
    s = torch.einsum("blkgh,bmkh->blkgm", q, k).to(torch.float32)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    ok = attention_mask(q_positions, kv_positions, window, prefix, max_kv)
    s = torch.where(ok[None, :, None, None, :], s,
                    torch.tensor(NEG, dtype=torch.float32, device=s.device))
    ms, ls, accs = [], [], []
    for k0, k1 in bounds:
        m = s[..., k0:k1].amax(-1).clamp_min(NEG)
        p = torch.exp(s[..., k0:k1] - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("blkgm,bmkh->blkgh", p.to(q.dtype).float(),
                                 v[:, k0:k1].float()))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def merge_partials_ref(m, l, acc, v):
    """The merge pass, float32 ``[B, Lq, KV, G, hd]``: the splits weighted by
    ``exp(m_s - max m)`` and summed in ascending order, ``acc / max(l,
    1e-30)``; a row whose max is still ``-1e30`` kept no key and averages
    ``v`` (``[B, M, KV, hd]``)."""
    mg = m.amax(0)
    lt = torch.zeros_like(mg)
    at = torch.zeros_like(acc[0])
    for s in range(m.shape[0]):
        w = torch.exp(m[s] - mg)
        lt = lt + l[s] * w
        at = at + acc[s] * w[..., None]
    out = at / lt.clamp_min(1e-30)[..., None]
    mean = v.float().mean(1)[:, None, :, None, :]
    return torch.where((mg == NEG)[..., None], mean, out)


def flash_attention_split_ref(q, k, v, q_positions, kv_positions, window,
                              prefix, max_kv, softcap=None, nsplit=2):
    """The key-split path in plain PyTorch: ``nsplit`` equal key ranges,
    their partials, the merge; in ``q``'s dtype."""
    M = k.shape[1]
    size = -(-M // nsplit)
    bounds = [(k0, min(M, k0 + size)) for k0 in range(0, M, size)]
    parts = split_partials_ref(q, k, v, q_positions, kv_positions, window,
                               prefix, max_kv, softcap, bounds)
    return merge_partials_ref(*parts, v).to(q.dtype)
