"""Neighborhood-aware trajectory segmentation — TSA1 & TSA2
(counterpart of ``repro.core.segmentation``).

Both algorithms slide ``W1 = [n-w, n-1]`` and ``W2 = [n, n+w-1]`` over a
per-point signal and cut where the window difference ``d[n]`` exceeds
``tau`` and is a local maximum of ``d[n-w+1 .. n+w-1]`` (strict left
tie-break, DESIGN.md §7).  TSA1 reads the normalized voting vector; TSA2
reads per-point neighbor sets as packed int32 words and uses the windowed
Jaccard dissimilarity, through the CUDA kernel when ``use_kernel=True``
(``repro_torch.kernels.jaccard``) — bit-identical ``d`` either way.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import SubtrajSegmentation, f32
from repro_torch.core.windows import popcount32, sliding_reduce, window_pair


def _window_means(sig: torch.Tensor, valid: torch.Tensor, w: int):
    """Means of W1=[n-w, n-1] and W2=[n, n+w-1] at every n; [T, M] each."""
    x = torch.where(valid, sig, 0.0)
    cnt = valid.to(torch.float32)
    s1, s2 = window_pair(x, w, "sum")
    c1, c2 = window_pair(cnt, w, "sum")
    return s1 / c1.clamp_min(1.0), s2 / c2.clamp_min(1.0)


def _local_max_cuts(d: torch.Tensor, valid: torch.Tensor, w: int, tau,
                    count: torch.Tensor) -> torch.Tensor:
    """Cut where d[n] > tau and d[n] is the max of its +-(w-1) window:
    it must beat the left neighbors strictly and the right ones with >=."""
    T, M = d.shape
    n = torch.arange(M, device=d.device)
    admissible = (n[None, :] >= w) & (n[None, :] <= count[:, None] - w - 1)
    d = torch.where(valid & admissible, d, float("-inf"))
    left = sliding_reduce(d, -(w - 1), -1, "max")
    right = sliding_reduce(d, 1, w - 1, "max")
    is_max = (d > left) & (d >= right)
    return is_max & (d > f32(tau, d.device)) & admissible & valid


def _finalize(cut: torch.Tensor, valid: torch.Tensor, score: torch.Tensor,
              max_subs: int) -> SubtrajSegmentation:
    first = valid & (torch.cumsum(valid, dim=1) == 1)
    cut = (cut | first) & valid
    sub_local = (torch.cumsum(cut, dim=1) - 1).clamp(0, max_subs - 1)
    sub_local = torch.where(valid, sub_local, -1).to(torch.int32)
    num = torch.where(valid, sub_local, -1).amax(dim=1) + 1
    return SubtrajSegmentation(cut=cut, sub_local=sub_local,
                               num_subs=num.to(torch.int32), score=score)


def tsa1(norm_vote: torch.Tensor, valid: torch.Tensor, w: int, tau,
         max_subs: int = 8) -> SubtrajSegmentation:
    """Algorithm 2: density-change segmentation over the voting signal."""
    count = valid.sum(dim=1)
    m1, m2 = _window_means(norm_vote, valid, w)
    d = (m1 - m2).abs()
    cuts = _local_max_cuts(d, valid, w, tau, count)
    return _finalize(cuts, valid, torch.where(valid, d, 0.0), max_subs)


def _window_overlap_counts(masks: torch.Tensor, w: int):
    """Per-position W1/W2 set-union intersection and union cardinalities,
    from the packed words (windowed OR, then popcount over the words)."""
    l1, l2 = window_pair(masks, w, "or")
    inter = popcount32(l1 & l2).sum(dim=-1, dtype=torch.int32)
    union = popcount32(l1 | l2).sum(dim=-1, dtype=torch.int32)
    return inter, union


def _windowed_union(word: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor) -> torch.Tensor:
    """Bit-plane oracle: the OR of one packed word column ``[T, M, 1]``
    over the position window ``[lo, hi]``, as ``[T, M, 32]`` bools, from
    cumulative counts of its 32 bit planes (an OR of 0/1 bits is a count
    above 0)."""
    T, M, _ = word.shape
    k = torch.arange(32, dtype=torch.int32, device=word.device)
    csum = torch.cumsum((word >> k) & 1, dim=1)                   # [T, M, 32]

    def take(idx):
        return csum[:, idx.clamp(0, M - 1)]

    hi_v = torch.where((hi >= 0)[None, :, None], take(hi), 0)
    lo_v = torch.where((lo > 0)[None, :, None], take(lo - 1), 0)
    return (hi_v - lo_v) > 0


def _window_overlap_counts_bitplane(masks: torch.Tensor, w: int):
    """The counts of ``_window_overlap_counts`` one word at a time through
    32 bit planes (peak extra memory ``[T, M, 32]``): the reference's
    retained oracle, a formulation independent of the packed engine."""
    T, M, W = masks.shape
    n = torch.arange(M, device=masks.device)
    inter = torch.zeros((T, M), dtype=torch.int32, device=masks.device)
    union = torch.zeros_like(inter)
    for wi in range(W):
        word = masks[:, :, wi:wi + 1]
        l1 = _windowed_union(word, n - w, n - 1)
        l2 = _windowed_union(word, n, n + w - 1)
        inter += (l1 & l2).sum(dim=-1, dtype=torch.int32)
        union += (l1 | l2).sum(dim=-1, dtype=torch.int32)
    return inter, union


def tsa2_signal(packed_masks: torch.Tensor, w: int, *,
                impl: str = "packed") -> torch.Tensor:
    """TSA2's windowed-Jaccard dissimilarity ``d[n]`` from packed words.

    ``impl="packed"`` is the packed-word engine, the plain version of the
    Jaccard kernel; ``impl="bitplane"`` the 32x-expanded oracle.  Both
    give the same integer counts and the same float operations, so the
    same ``d`` bit for bit."""
    if impl == "packed":
        inter, union = _window_overlap_counts(packed_masks, w)
    elif impl == "bitplane":
        inter, union = _window_overlap_counts_bitplane(packed_masks, w)
    else:
        raise ValueError(f"unknown tsa2 signal impl {impl!r}")
    inter = inter.to(torch.float32)
    union = union.to(torch.float32)
    return torch.where(union > 0, 1.0 - inter / union.clamp_min(1.0), 0.0)


def tsa2(packed_masks: torch.Tensor, valid: torch.Tensor, w: int, tau,
         max_subs: int = 8, *, use_kernel: bool = False) -> SubtrajSegmentation:
    """Algorithm 3: composition-change segmentation (windowed Jaccard).

    Words at invalid positions count as zero on both engines, so they see
    the same sets and agree bit for bit, score included: the plain engine
    zeroes them here, the kernel's wrapper (``window_jaccard``) in its own
    plain path or, on the card, in the kernel as the words arrive.
    """
    count = valid.sum(dim=1)
    if use_kernel:
        from repro_torch.kernels.jaccard.ops import window_jaccard
        d = window_jaccard(packed_masks, valid, w=w)
    else:
        d = tsa2_signal(torch.where(valid[..., None], packed_masks, 0), w)
    cuts = _local_max_cuts(d, valid, w, tau, count)
    return _finalize(cuts, valid, torch.where(valid, d, 0.0), max_subs)


def segment(params_segmentation: str, *, norm_vote=None, packed_masks=None,
            valid=None, w: int = 10, tau=0.4, max_subs: int = 8,
            use_kernel: bool = False) -> SubtrajSegmentation:
    """``tsa1`` over ``norm_vote`` or ``tsa2`` over ``packed_masks`` (with
    ``use_kernel``), by name, as the reference dispatches."""
    if params_segmentation == "tsa1":
        return tsa1(norm_vote, valid, w, tau, max_subs)
    if params_segmentation == "tsa2":
        return tsa2(packed_masks, valid, w, tau, max_subs,
                    use_kernel=use_kernel)
    raise ValueError(f"unknown segmentation {params_segmentation!r}")
