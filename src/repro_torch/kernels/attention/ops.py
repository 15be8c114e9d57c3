"""Public wrapper for the attention forward kernels (counterpart of
``repro.kernels.attention.ops`` and ``flash.flash_attention_fwd``).

``flash_attention`` moves its operands to ``device`` (``None`` = the card)
and calls ``flash_attention_fwd``: on CUDA tensors it launches the
``flash_attention_fwd`` launcher (``csrc/attention_kernels.cu``, an
online-softmax pass that never materialises the scores); on CPU tensors
it takes the plain version (``ref.flash_attention_ref``).  Any ``B``,
``Lq``, ``M``, ``KV``, ``G`` and ``hd``; float32 or bfloat16.

``plan_fwd`` picks the launcher's path by shape:

* ``bf16_mma``: bfloat16 with ``hd`` a multiple of 8 up to 256, on the
  tensor cores (``mma.sync``);
* ``f32_tiled``: float32 with ``hd`` a multiple of 4 up to 256, a
  register-tiled CUDA-core kernel;
* ``general``: every other shape (or operands not 16-byte aligned), a
  CUDA-core kernel with the output dims chunked over the grid.

All three skip (row block, key tile) pairs that the mask removes
entirely (``ref.tile_class_ref`` mirrors the test).  When the row blocks
cannot fill the card (decode), the keys are split across blocks and a
merge pass combines the splits (``ref.merge_partials_ref`` mirrors it).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import check_cuda_operands, launch, resolve_device
from repro_torch.kernels.attention.ref import flash_attention_ref

HUGE = 1 << 30
PATHS = ("bf16_mma", "f32_tiled", "general")
GENERAL_DIMS = 256          # output dims per block of the general path


@dataclass(frozen=True)
class Plan:
    """How ``flash_attention_fwd`` runs a shape: the path, its rows per
    block and keys per tile (as ``attention_kernels.cu`` has them), and the
    key split (``nsplit`` ranges of ``tiles_per_split`` tiles)."""
    path: str
    rows: int
    keys: int
    nsplit: int
    tiles_per_split: int


def tile_shape(path: str, hd: int) -> tuple[int, int]:
    """Rows per block and keys per tile of ``path`` at head dim ``hd``."""
    if path == "general":
        return 32, 32
    hd_class = 64 if hd <= 64 else 128 if hd <= 128 else 256
    if path == "bf16_mma":
        return 64, 64 if hd_class <= 128 else 32
    return 64, 64 if hd_class == 64 else 32


def plan_fwd(B, Lq, M, KV, G, hd, dtype, *, aligned=True,
             n_sm=132) -> Plan:
    """The path by dtype, ``hd`` and alignment; a key split when the
    blocks (row blocks x ``B * KV``, times the dim chunks of the general
    path) number fewer than ``n_sm``: about two blocks an SM, in ranges of
    whole tiles."""
    if dtype == torch.bfloat16 and hd % 8 == 0 and hd <= 256 and aligned:
        path = "bf16_mma"
    elif dtype == torch.float32 and hd % 4 == 0 and hd <= 256 and aligned:
        path = "f32_tiled"
    else:
        path = "general"
    rows, keys = tile_shape(path, hd)
    ntiles = -(-M // keys)
    blocks = -(-(Lq * G) // rows) * B * KV
    if path == "general":
        blocks *= -(-hd // GENERAL_DIMS)
    tps = ntiles
    if blocks < n_sm and ntiles > 1:
        want = min(ntiles, -(-2 * n_sm // blocks))
        tps = -(-ntiles // want)
    return Plan(path, rows, keys, -(-ntiles // tps), tps)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(q, k, v) -> Plan:
    """``plan_fwd`` for these operands on their card."""
    B, Lq, KV, G, hd = q.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return plan_fwd(B, Lq, k.shape[1], KV, G, hd, q.dtype, aligned=aligned,
                    n_sm=_sm_count(q.device.index or 0))


def flash_attention_fwd(q, k, v, q_positions, kv_positions, window, prefix,
                        max_kv, *, softcap=None, stats=None):
    """q: [B, Lq, KV, G, hd]; k/v: [B, M, KV, hd].  Returns [B, Lq, KV, G,
    hd] in q's dtype.  Positions are int32 vectors; window / prefix /
    max_kv integers (``HUGE`` / 0 / ``HUGE`` disable them).  ``stats``: an
    int32 CUDA tensor of 2 to which the launch adds the (row block, key
    tile) pairs it swept and those it skipped."""
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
    i32, f32 = torch.int32, torch.float32
    dev = check_cuda_operands("flash_attention_fwd", q=(q, q.dtype),
                              k=(k, q.dtype), v=(v, q.dtype),
                              q_positions=(q_positions, i32),
                              kv_positions=(kv_positions, i32))
    if q_positions.shape != (Lq,) or kv_positions.shape != (M,):
        raise ValueError("flash_attention_fwd: positions must be [Lq] and "
                         "[M]")
    if stats is not None:
        check_cuda_operands("flash_attention_fwd", q=(q, q.dtype),
                            stats=(stats, i32))
        if stats.numel() != 2:
            raise ValueError("flash_attention_fwd: stats must hold 2 counts")
    plan = plan_for(q, k, v)
    out = torch.empty_like(q)
    parts = [0, 0, 0]
    if plan.nsplit > 1:         # m, l and acc of every split, one buffer
        n = plan.nsplit * B * KV * Lq * G
        scratch = torch.empty(n * (hd + 2), dtype=f32, device=dev)
        base = scratch.data_ptr()
        parts = [base, base + 4 * n, base + 8 * n]
    launch("flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           q_positions.data_ptr(), kv_positions.data_ptr(), B, Lq, M, KV, G,
           hd, int(window), int(prefix), int(max_kv),
           0.0 if softcap is None else float(softcap),
           int(q.dtype == torch.bfloat16), PATHS.index(plan.path),
           plan.nsplit, plan.tiles_per_split, *parts,
           0 if stats is None else stats.data_ptr(), out.data_ptr(),
           device=dev)
    return out


def flash_attention(q, k, v, q_positions, kv_positions, *, window=None,
                    prefix=None, max_kv=None, softcap=None, interpret=None,
                    device=None):
    """GQA attention forward with causal, sliding-window (``window``),
    prefix-LM (``prefix``), softcap and ``max_kv`` masks; ``None`` disables
    each.  ``device``: where to run (``None`` = the card).  The
    reference's ``interpret`` (Pallas' interpret mode) is accepted and
    ignored."""
    dev = resolve_device(device)
    q, k, v = (torch.as_tensor(a, device=dev).contiguous() for a in (q, k, v))
    qp, kp = (torch.as_tensor(a, device=dev).to(torch.int32).contiguous()
              for a in (q_positions, kv_positions))
    return flash_attention_fwd(
        q, k, v, qp, kp, HUGE if window is None else window,
        0 if prefix is None else prefix, HUGE if max_kv is None else max_kv,
        softcap=softcap)
