"""Public wrapper for the attention forward kernel (counterpart of
``repro.kernels.attention.ops`` and ``flash.flash_attention_fwd``).

``flash_attention`` moves its operands to ``device`` (``None`` = the card)
and calls ``flash_attention_fwd``: on CUDA tensors it launches the
``flash_attention_fwd`` kernel (``csrc/attention_kernels.cu``, an
online-softmax pass that never materialises the scores); on CPU tensors
it takes the plain version (``ref.flash_attention_ref``).  Any ``Lq`` and
``M``; ``hd`` up to 256; float32 or bfloat16.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check_cuda_operands, launch, resolve_device
from repro_torch.kernels.attention.ref import flash_attention_ref

HUGE = 1 << 30
MAX_HEAD_DIM = 256


def flash_attention_fwd(q, k, v, q_positions, kv_positions, window, prefix,
                        max_kv, *, softcap=None):
    """q: [B, Lq, KV, G, hd]; k/v: [B, M, KV, hd].  Returns [B, Lq, KV, G,
    hd] in q's dtype.  Positions are int32 vectors; window / prefix /
    max_kv integers (``HUGE`` / 0 / ``HUGE`` disable them)."""
    B, Lq, KV, G, hd = q.shape
    M = k.shape[1]
    if M == 0:
        raise ValueError("flash_attention_fwd: no keys (M = 0)")
    if k.shape != (B, M, KV, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, q_positions, kv_positions,
                                   window, prefix, max_kv, softcap=softcap)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention_fwd: {q.dtype} is neither float32 "
                        "nor bfloat16")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_fwd: hd = {hd} > {MAX_HEAD_DIM}")
    if B * KV > 65535:               # the grid's second dimension
        raise ValueError(f"flash_attention_fwd: B * KV = {B * KV} > 65535")
    i32 = torch.int32
    dev = check_cuda_operands("flash_attention_fwd", q=(q, q.dtype),
                              k=(k, q.dtype), v=(v, q.dtype),
                              q_positions=(q_positions, i32),
                              kv_positions=(kv_positions, i32))
    if q_positions.shape != (Lq,) or kv_positions.shape != (M,):
        raise ValueError("flash_attention_fwd: positions must be [Lq] and "
                         "[M]")
    out = torch.empty_like(q)
    launch("flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           q_positions.data_ptr(), kv_positions.data_ptr(), B, Lq, M, KV, G,
           hd, int(window), int(prefix), int(max_kv),
           0.0 if softcap is None else float(softcap),
           int(q.dtype == torch.bfloat16), out.data_ptr(), device=dev)
    return out


def flash_attention(q, k, v, q_positions, kv_positions, *, window=None,
                    prefix=None, max_kv=None, softcap=None, device=None):
    """GQA attention forward with causal, sliding-window (``window``),
    prefix-LM (``prefix``), softcap and ``max_kv`` masks; ``None`` disables
    each.  ``device``: where to run (``None`` = the card)."""
    dev = resolve_device(device)
    q, k, v = (torch.as_tensor(a, device=dev).contiguous() for a in (q, k, v))
    qp, kp = (torch.as_tensor(a, device=dev).to(torch.int32).contiguous()
              for a in (q_positions, kv_positions))
    return flash_attention_fwd(
        q, k, v, qp, kp, HUGE if window is None else window,
        0 if prefix is None else prefix, HUGE if max_kv is None else max_kv,
        softcap=softcap)
