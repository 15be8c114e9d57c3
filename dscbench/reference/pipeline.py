"""DSC in plain PyTorch and numpy: the reference that the program's
outputs are judged against.

The semantics are the paper's, with the float conventions the program
states for them, so that an exact implementation agrees bit for bit:

* join (Problem 1): point ``q`` of candidate trajectory ``c`` matches
  reference point ``p`` when ``dx*dx + dy*dy <= eps_sp**2`` and
  ``|t_p - t_q| <= eps_t`` (float32, no fused multiply-add), with weight
  ``1 - sqrt(d2) / eps_sp`` (a correctly rounded root); per ``(p, c)``
  the best weight, ties to the lowest ``q``; a best weight of 0 is no
  match; points of one trajectory id never match.  ``delta_t`` is 0.
* voting: ``V(p)`` adds the best weights over ``c`` in ascending order,
  one rounded add at a time from +0.0.
* TSA2 (Algorithm 3): per-point neighbour sets, windowed unions over
  ``[n-w, n-1]`` and ``[n, n+w-1]``, Jaccard dissimilarity, cuts at
  strict-left / weak-right local maxima above ``tau`` in
  ``[w, count-w-1]``; at most ``max_subs`` subtrajectories a row.
* similarity (Eq. 2): every best match adds its weight to the cell
  (sub(p), sub(c, q)), in ascending point position; divided by the
  smaller cardinality, max-symmetrised, diagonal and empty slots 0.
* thresholds: ``mean + sigma * std`` of the positive similarities (per
  row along a fixed pairwise tree) and of the slot votings.
* clustering (Algorithm 4): the sequential greedy pass in voting order,
  on the host, over the alpha-edges.

The join visits, for each reference point, only the candidate points
whose times lie within ``eps_t`` (plus a margin far above rounding) of
its own, found by binary search in each time-sorted row; the exact tests
decide inside that window, so the result is the all-pairs join's.
Everything runs in blocks on the device it is given.  ``dtype`` is the
precision of the arithmetic: float32 as the configuration states it, or
a lower one for the control.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# elements of one [C, queries] block of the join
JOIN_BLOCK_ELEMENTS = 1 << 25
# rows of [S, S] per block of the dense passes
ROW_BLOCK = 4096
# matches gathered before their ordered adds run
MATCH_BUDGET = 1 << 26


@dataclasses.dataclass
class Reference:
    """The reference's outputs of one slice, layer by layer."""

    vote: torch.Tensor        # [T, M]
    score: torch.Tensor       # [T, M] TSA2 signal d (0 on padding)
    sub_local: torch.Tensor   # [T, M] int64 (-1 on padding)
    t_start: torch.Tensor     # [S]
    t_end: torch.Tensor       # [S]
    card: torch.Tensor        # [S] int64
    voting: torch.Tensor      # [S]
    valid: torch.Tensor       # [S] bool
    sim: torch.Tensor         # [S, S]
    alpha: float
    k: float
    member_of: np.ndarray     # [S] int32
    is_rep: np.ndarray        # [S] bool
    is_outlier: np.ndarray    # [S] bool
    alpha_degree: np.ndarray  # [S] alpha-edges a row
    n_pairs: int              # point pairs inside both thresholds
    n_best: int               # best matches (point, candidate trajectory)

    def topk_k(self, k0: int) -> int:
        """The K at which top-K lists hold every alpha-edge: ``k0``
        doubled (never past S) until no row has more than K."""
        S = self.valid.shape[0]
        need = int(self.alpha_degree.max(initial=0))
        k = min(k0, S)
        while k < need:
            k = min(2 * k, S)
        return k


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """A correctly rounded root in x's precision."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _scalar(v, dtype, device) -> torch.Tensor:
    """A parameter as float32 rounded to ``dtype``, a 0-d tensor."""
    return torch.tensor(v, dtype=torch.float32, device=device).to(dtype)


def join_blocks(x, y, t, valid, ids, eps_sp, eps_t, dtype=torch.float32):
    """The self-join's best matches (see the module docstring), one block
    of reference rows at a time: yields ``(p, c, q, w, n_pairs)``, the
    block's matches in (point, candidate) order -- flat reference point
    ``row * M + m``, candidate row, best candidate position (int64), weight
    (``dtype``) -- and its count of point pairs inside both thresholds."""
    T, M = x.shape
    dev = x.device
    xs, ys, ts = (a.to(dtype) for a in (x, y, t))
    eps = _scalar(eps_sp, dtype, dev)
    eps2 = eps * eps
    et = _scalar(eps_t, dtype, dev)
    # the binary search runs in float64 on the rounded values; the margin
    # lies far above the rounding of one difference in either precision
    margin = float(et) * 2.0 ** -6
    t64 = ts.to(torch.float64)
    rows = torch.where(valid, t64, torch.inf).contiguous()       # [C, M]
    flat_x, flat_y, flat_t = xs.reshape(-1), ys.reshape(-1), ts.reshape(-1)
    flat_ok = valid.reshape(-1)
    R = max(1, JOIN_BLOCK_ELEMENTS // (T * M))
    crow = torch.arange(T, device=dev)[:, None] * M
    for r0 in range(0, T, R):
        r1 = min(T, r0 + R)
        Q = (r1 - r0) * M
        qx, qy, qt = (a[r0:r1].reshape(1, Q) for a in (xs, ys, ts))
        qok = valid[r0:r1].reshape(1, Q)
        qid = ids[r0:r1, None].expand(r1 - r0, M).reshape(1, Q)
        q64 = torch.where(qok, t64[r0:r1].reshape(1, Q), torch.nan)
        lo = torch.searchsorted(
            rows, (q64 - float(et) - margin).expand(T, Q).contiguous())
        hi = torch.searchsorted(
            rows, (q64 + float(et) + margin).expand(T, Q).contiguous(),
            right=True)
        width = int((hi - lo).max())
        best_w = torch.full((T, Q), -1.0, dtype=dtype, device=dev)
        best_q = torch.full((T, Q), -1, dtype=torch.int64, device=dev)
        n_pairs = 0
        for k in range(width):
            j = lo + k
            flat = crow + j.clamp(max=M - 1)
            dx = qx - flat_x[flat]
            dy = qy - flat_y[flat]
            dt = (qt - flat_t[flat]).abs()
            d2 = dx * dx + dy * dy
            ok = ((j < hi) & flat_ok[flat] & qok & (d2 <= eps2) & (dt <= et)
                  & (ids[:, None] != qid))
            n_pairs += int(ok.sum())
            w = torch.where(ok, 1.0 - _sqrt(d2) / eps, -1.0).to(dtype)
            better = w > best_w
            best_w = torch.where(better, w, best_w)
            best_q = torch.where(better, j, best_q)
            del dx, dy, dt, d2, ok, w, better, flat
        del lo, hi
        qi, ci = torch.nonzero(best_w.t() > 0.0, as_tuple=True)
        yield qi + r0 * M, ci, best_q[ci, qi], best_w[ci, qi], n_pairs
        del best_w, best_q


def _batched(blocks, budget: int):
    """Concatenate consecutive blocks of ``join_blocks`` up to about
    ``budget`` matches; yields ``(p, c, q, w)``."""
    buf, n = [], 0
    for blk in blocks:
        buf.append(blk[:4])
        n += blk[0].numel()
        if n >= budget:
            yield tuple(torch.cat(z) for z in zip(*buf))
            buf, n = [], 0
    if buf:
        yield tuple(torch.cat(z) for z in zip(*buf))


def _ordered_runs(group: torch.Tensor):
    """Split entries sorted by ``group`` into rounds: round r holds the
    r-th entry of every group, so no group repeats within a round.
    Yields index tensors, round 0 first."""
    n = group.numel()
    if n == 0:
        return
    counts = torch.bincount(group)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=group.device) - starts[group]
    order = torch.argsort(rank, stable=True)
    off = 0
    for s in torch.bincount(rank).tolist():
        yield order[off:off + s]
        off += s


def vote_and_words(x, y, t, valid, ids, params: dict, dtype):
    """Pass 1 of the join: ``(vote [T, M], words [T*M, W] int32 bit
    patterns, n_pairs, n_best)``.  ``V(p)`` adds the best weights over
    ascending candidates, one rounded add at a time from +0.0; bit
    ``c % 32`` of word ``c // 32`` is set iff candidate ``c`` matches."""
    T, M = x.shape
    P, W = T * M, -(-T // 32)
    dev = x.device
    vote = torch.zeros((P,), dtype=dtype, device=dev)
    words = torch.zeros((P, W), dtype=torch.int32, device=dev)
    n_pairs = [0]

    def blocks():
        for *match, n in join_blocks(x, y, t, valid, ids, params["eps_sp"],
                                     params["eps_t"], dtype):
            n_pairs[0] += n
            yield match

    n_best = 0
    for p, c, _, w in _batched(blocks(), MATCH_BUDGET):
        if p.numel() == 0:
            continue
        n_best += p.numel()
        for sel in _ordered_runs(p):
            vote.index_put_((p[sel],), w[sel], accumulate=True)
        lo, hi = int(p[0]), int(p[-1]) + 1
        # distinct bits: the int64 sum of a word is its OR
        acc = torch.zeros(((hi - lo) * W,), dtype=torch.int64, device=dev)
        acc.scatter_add_(0, (p - lo) * W + c // 32,
                         torch.ones_like(c) << (c % 32))
        acc = torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc)
        words[lo:hi] = acc.view(hi - lo, W).to(torch.int32)
    return vote.view(T, M), words, n_pairs[0], n_best


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int64 values below 2**32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _shifted(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """``x`` along axis 1 so that position n reads position n - k (``fill``
    outside the row)."""
    out = torch.full_like(x, fill)
    M = x.shape[1]
    if k >= 0 and k < M:
        out[:, k:] = x[:, :M - k]
    elif k < 0 and -k < M:
        out[:, :M + k] = x[:, -k:]
    return out


def tsa2_signal(words: torch.Tensor, valid: torch.Tensor, w: int,
                dtype) -> torch.Tensor:
    """From the int32 words ``[T*M, W]``: the windowed Jaccard dissimilarity ``d[n]`` between the unions of the
    sets at positions ``[n-w, n-1]`` and ``[n, n+w-1]``."""
    T, M = valid.shape
    words = torch.where(valid.reshape(-1, 1), words.to(torch.int64)
                        & 0xFFFFFFFF, 0).view(T, M, -1)
    before = torch.zeros_like(words)
    after = torch.zeros_like(words)
    for k in range(1, w + 1):
        before |= _shifted(words, k, 0)
    for k in range(0, w):
        after |= _shifted(words, -k, 0)
    inter = _popcount(before & after).sum(-1).to(dtype)
    union = _popcount(before | after).sum(-1).to(dtype)
    return torch.where(union > 0, 1.0 - inter / union.clamp_min(1.0),
                       0.0).to(dtype)


def segment(d: torch.Tensor, valid: torch.Tensor, w: int, tau: float,
            max_subs: int):
    """Cuts at the local maxima of ``d`` above ``tau``: ``sub_local``
    (int64 [T, M], -1 on padding)."""
    T, M = d.shape
    count = valid.sum(dim=1)
    n = torch.arange(M, device=d.device)
    admissible = (n[None, :] >= w) & (n[None, :] <= count[:, None] - w - 1)
    dm = torch.where(valid & admissible, d, float("-inf"))
    left = torch.full_like(dm, float("-inf"))
    right = torch.full_like(dm, float("-inf"))
    for k in range(1, w):
        left = torch.maximum(left, _shifted(dm, k, float("-inf")))
        right = torch.maximum(right, _shifted(dm, -k, float("-inf")))
    tau_t = _scalar(tau, d.dtype, d.device)
    cut = ((dm > left) & (dm >= right) & (dm > tau_t) & admissible & valid)
    first = valid & (torch.cumsum(valid, dim=1) == 1)
    cut = (cut | first) & valid
    sub = (torch.cumsum(cut, dim=1) - 1).clamp(0, max_subs - 1)
    return torch.where(valid, sub, -1)


def slot_table(t, valid, sub_local, vote, max_subs: int, dtype):
    """Per slot ``row * max_subs + sub``: first and last time, count of
    points, mean voting, and whether it holds a point."""
    T, M = t.shape
    S = T * max_subs
    dev = t.device
    rows = torch.arange(T, device=dev)[:, None]
    flat = torch.where(sub_local >= 0, rows * max_subs + sub_local,
                       S).reshape(-1)
    big = torch.finfo(dtype).max
    ts = t.to(dtype)
    t_start = torch.full((S + 1,), big, dtype=dtype, device=dev).scatter_reduce(
        0, flat, torch.where(valid, ts, big).reshape(-1), "amin")[:S]
    t_end = torch.full((S + 1,), -big, dtype=dtype, device=dev).scatter_reduce(
        0, flat, torch.where(valid, ts, -big).reshape(-1), "amax")[:S]
    card = torch.zeros((S + 1,), dtype=torch.int64, device=dev).index_put_(
        (flat,), valid.reshape(-1).to(torch.int64), accumulate=True)[:S]
    vsum = torch.zeros((S + 1,), dtype=dtype, device=dev).index_put_(
        (flat,), torch.where(valid, vote, 0.0).reshape(-1).to(dtype),
        accumulate=True)[:S]
    ok = card > 0
    vmean = torch.where(ok, vsum / card.clamp_min(1).to(dtype), 0.0)
    return (torch.where(ok, t_start, 0.0), torch.where(ok, t_end, 0.0),
            card, vmean.to(dtype), ok)


def similarity(x, y, t, valid, ids, params: dict, sub_local, card,
               valid_slot, dtype):
    """Pass 2 of the join: the dense Eq. 2 matrix ``[S, S]``."""
    T, M = sub_local.shape
    ms = params["max_subtrajs_per_traj"]
    S = T * ms
    dev = sub_local.device
    raw = torch.zeros((S * S,), dtype=dtype, device=dev)
    blocks = join_blocks(x, y, t, valid, ids, params["eps_sp"],
                         params["eps_t"], dtype)
    for p, c, q, w in _batched((b[:4] for b in blocks), MATCH_BUDGET):
        r, m = p // M, p % M
        src, dst = sub_local[r, m], sub_local[c, q]
        keep = (src >= 0) & (dst >= 0)
        cell = ((r * ms + src) * S + c * ms + dst)[keep]
        w, m = w[keep], m[keep]
        # a cell's rows are fixed, so it gets at most one match a point
        # position: add position by position, in ascending order
        order = torch.argsort(m, stable=True)
        cell, w, m = cell[order], w[order], m[order]
        bounds = torch.searchsorted(m, torch.arange(M + 1,
                                                    device=dev)).tolist()
        for i in range(M):
            s = slice(bounds[i], bounds[i + 1])
            raw.index_put_((cell[s],), w[s], accumulate=True)
    raw = raw.view(S, S)
    cardf = card.to(dtype)
    idx = torch.arange(S, device=dev)
    B = ROW_BLOCK
    for i0 in range(0, S, B):
        i = slice(i0, i0 + B)
        for j0 in range(i0, S, B):
            j = slice(j0, j0 + B)
            denom = torch.minimum(cardf[i, None], cardf[None, j]).clamp_min(1)
            sym = torch.maximum(raw[i, j], raw[j, i].t()) / denom
            keep = (valid_slot[i, None] & valid_slot[None, j]
                    & (idx[i, None] != idx[None, j]))
            sym = torch.where(keep, sym, 0.0)
            raw[i, j] = sym
            raw[j, i] = sym.t()
    return raw


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums along a fixed pairwise tree (zero-padded to a power of
    two)."""
    n = x.shape[1]
    p = 1 << max(n - 1, 0).bit_length()
    x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[1] > 1:
        x = x[:, 0::2] + x[:, 1::2]
    return x[:, 0]


def thresholds(sim, voting, valid_slot, params: dict, dtype):
    """``(alpha, k)`` as ``mean + sigma * std`` (0-d tensors)."""
    S = sim.shape[0]
    dev = sim.device
    cnt, rsum, rsq = [], [], []
    for i0 in range(0, S, ROW_BLOCK):
        rows = sim[i0:i0 + ROW_BLOCK]
        pos = ((rows > 0.0) & valid_slot[i0:i0 + ROW_BLOCK, None]
               & valid_slot[None, :])
        xv = torch.where(pos, rows, 0.0)
        cnt.append(_tree_sum(pos.to(torch.int32)))
        rsum.append(_tree_sum(xv))
        rsq.append(_tree_sum(xv * xv))
    cnt, rsum, rsq = torch.cat(cnt), torch.cat(rsum), torch.cat(rsq)
    n_pos = cnt.sum().clamp_min(1)
    s_mean = rsum.sum() / n_pos
    s_var = (rsq.sum() / n_pos - s_mean * s_mean).clamp_min(0.0)
    alpha = s_mean + _scalar(params["alpha_sigma"], dtype, dev) * torch.sqrt(s_var)
    nv = valid_slot.sum().clamp_min(1)
    v_mean = torch.where(valid_slot, voting, 0.0).sum() / nv
    v_var = torch.where(valid_slot, (voting - v_mean) ** 2, 0.0).sum() / nv
    k = v_mean + _scalar(params["k_sigma"], dtype, dev) * torch.sqrt(v_var)
    return alpha.to(dtype), k.to(dtype)


def alpha_edges(sim: torch.Tensor, alpha: torch.Tensor):
    """The alpha-edges ``sim > 0 and sim >= alpha`` as host CSR:
    ``(indptr [S+1], cols, vals)`` (rows in order, columns ascending)."""
    S = sim.shape[0]
    rows, cols, vals = [], [], []
    for i0 in range(0, S, ROW_BLOCK):
        blk = sim[i0:i0 + ROW_BLOCK]
        r, c = torch.nonzero((blk > 0.0) & (blk >= alpha), as_tuple=True)
        rows.append((r + i0).cpu())
        cols.append(c.to(torch.int32).cpu())
        vals.append(blk[r, c].float().cpu())
    r = torch.cat(rows).numpy()
    indptr = np.zeros(S + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=S), out=indptr[1:])
    return indptr, torch.cat(cols).numpy(), torch.cat(vals).numpy()


def cluster(voting: np.ndarray, valid: np.ndarray, k: np.float32, indptr,
            cols, vals):
    """Algorithm 4, one visited slot at a time in voting order (ties by
    slot): ``(member_of, is_rep, is_outlier)``."""
    S = voting.shape[0]
    key = np.where(valid, voting.astype(np.float64), -np.inf)
    order = np.argsort(-key, kind="stable")
    potential = valid & (voting >= k)
    member_of = np.full(S, -1, np.int32)
    member_sim = np.zeros(S, np.float32)
    is_rep = np.zeros(S, bool)
    for s in order:
        if not potential[s] or member_of[s] >= 0:
            continue
        u = cols[indptr[s]:indptr[s + 1]]
        w = vals[indptr[s]:indptr[s + 1]]
        claim = ~is_rep[u] & (w > member_sim[u])
        member_of[u[claim]] = s
        member_sim[u[claim]] = w[claim]
        member_of[s] = s
        member_sim[s] = np.inf
        is_rep[s] = True
    return member_of, is_rep, valid & (member_of < 0)


def run(arrays, params: dict, dtype=torch.float32) -> Reference:
    """The whole pipeline on ``arrays = (x, y, t, valid, traj_id)``
    tensors, on the device they lie on."""
    x, y, t, valid, ids = arrays
    if params["delta_t"] != 0.0 or params["segmentation"] != "tsa2":
        raise ValueError("the reference covers delta_t = 0 under TSA2")
    ms = params["max_subtrajs_per_traj"]
    vote, words, n_pairs, n_best = vote_and_words(x, y, t, valid, ids,
                                                  params, dtype)
    d = torch.where(valid, tsa2_signal(words, valid, params["w"], dtype),
                    0.0)
    del words
    sub = segment(d, valid, params["w"], params["tau"], ms)
    t_start, t_end, card, vmean, ok = slot_table(t, valid, sub, vote, ms,
                                                 dtype)
    sim = similarity(x, y, t, valid, ids, params, sub, card, ok, dtype)
    alpha, k = thresholds(sim, vmean, ok, params, dtype)
    indptr, cols, vals = alpha_edges(sim, alpha)
    member_of, is_rep, is_out = cluster(
        vmean.float().cpu().numpy(), ok.cpu().numpy(),
        np.float32(float(k)), indptr, cols, vals)
    return Reference(vote=vote, score=d, sub_local=sub, t_start=t_start,
                     t_end=t_end, card=card, voting=vmean, valid=ok,
                     sim=sim, alpha=float(alpha), k=float(k),
                     member_of=member_of, is_rep=is_rep, is_outlier=is_out,
                     alpha_degree=np.diff(indptr), n_pairs=n_pairs,
                     n_best=n_best)

