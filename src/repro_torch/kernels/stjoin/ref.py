"""Plain PyTorch versions of the join kernels (same flattened contracts as
``repro.kernels.stjoin.ref.stjoin_ref`` and the fused passes
``stjoin_vote_fused_flat`` / ``stjoin_sim_fused_flat`` /
``stjoin_sim_panel_fused_flat`` of ``repro.kernels.stjoin.stjoin``, and
their index-pruned twins ``stjoin_pallas_pruned`` and
``stjoin_*_fused_pruned_flat``).

The fused passes are composed from the K1 plain version, the delta_t
refine (``run_refine``) and the two consumers (``vote_words_ref`` and the
materialize path's own scatter, ``core.similarity.scatter_raw``), each of
which fixes the float summation order the CUDA kernels use, so kernel and
plain version agree bit for bit on the card.

The pruned versions take a tile plan ``tiles = (tile_ids, bp, bc)``:
``tile_ids [nRb, K]`` lists, per block of ``bp`` consecutive reference
points, the ascending ids of the blocks of ``bc`` consecutive candidates
to sweep (-1 padded).  Only those pairs are swept (``stjoin_pruned_ref``);
every other pair stays at ``(0, -1)``, which is what the dense sweep gives
it when the plan is conservative, so each pruned version equals its dense
one bit for bit.  Any geometry is accepted.
"""
from __future__ import annotations

import torch

from repro_torch.core.geometry import filter_delta_t
from repro_torch.core.similarity import (panel_local, panel_members,
                                         scatter_raw)
from repro_torch.core.types import JoinResult, f32, sqrt_rn
from repro_torch.core.windows import pack_bits

# elements of one [rows, C, Mc] broadcast temporary
CHUNK_ELEMENTS = 1 << 27
# elements of one [rows, M, C] block of the refine (its temporaries are
# several int64 copies)
REFINE_ELEMENTS = 1 << 22
# candidate columns transposed at a time by the ordered vote sum
VOTE_COLUMNS = 256
# reference points packed into words at a time
PACK_ROWS = 8192


def stjoin_ref(ref_x, ref_y, ref_t, ref_id, ref_ok,
               cand_x, cand_y, cand_t, cand_id, cand_ok, eps_sp, eps_t, *,
               pair_mask=None, chunk_elements: int = CHUNK_ELEMENTS):
    """Returns ``(best_w [P, C] f32, best_idx [P, C] i32)``.

    Reference points ``[P]`` against candidate trajectories ``[C, Mc]``.
    ``pair_mask``: optional ``[P, C]`` bool candidate-pruning mask from
    the index; pairs masked False are skipped, so a conservative mask
    leaves the output unchanged.  The ``[P, C, Mc]`` broadcast runs in
    chunks of reference points.
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
        if pair_mask is not None:
            ok &= pair_mask[p, :, None]
        w = torch.where(ok, 1.0 - sqrt_rn(d2) / eps_sp, -1.0)
        bw = w.amax(dim=-1)
        arg = w.argmax(dim=-1)
        best_w[p] = bw.clamp_min(0.0)
        best_idx[p] = torch.where(bw > 0.0, arg.to(torch.int32), -1)
    return best_w, best_idx


def tile_keep(tile_ids: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """A tile plan as a ``[nRb, n_tiles]`` bool (ids outside the range,
    -1 included, are dropped)."""
    dev = tile_ids.device
    live = (tile_ids >= 0) & (tile_ids < n_tiles)
    keep = torch.zeros((tile_ids.shape[0], n_tiles + 1), dtype=torch.bool,
                       device=dev)
    keep.scatter_(1, torch.where(live, tile_ids, n_tiles).long(), True)
    return keep[:, :n_tiles]


def stjoin_pruned_ref(ref_x, ref_y, ref_t, ref_id, ref_ok,
                      cand_x, cand_y, cand_t, cand_id, cand_ok, tile_ids,
                      eps_sp, eps_t, *, bp: int, bc: int, ref_points=None,
                      cand_cols=None):
    """K10's plain version: ``(best_w [P, C], best_idx [P, C])`` with only
    the (reference block, candidate tile) pairs ``tile_ids`` names swept
    (by ``stjoin_ref``, one candidate tile at a time), ``(0, -1)``
    elsewhere.

    ``ref_points [P]`` / ``cand_cols [C]``: the points' and candidates'
    indices in the arrays the plan was built for, when the operands are a
    subset of them (default: the operands are those arrays).
    """
    P, C = ref_x.shape[0], cand_x.shape[0]
    dev = ref_x.device
    ref = (ref_x, ref_y, ref_t, ref_id, ref_ok)
    cand = (cand_x, cand_y, cand_t, cand_id, cand_ok)
    if ref_points is None:
        ref_points = torch.arange(P, device=dev)
    if cand_cols is None:
        cand_cols = torch.arange(C, device=dev)
    best_w = torch.zeros((P, C), dtype=torch.float32, device=dev)
    best_idx = torch.full((P, C), -1, dtype=torch.int32, device=dev)
    if P == 0 or C == 0:
        return best_w, best_idx
    block = torch.div(ref_points, bp, rounding_mode="floor")
    tile = torch.div(cand_cols, bc, rounding_mode="floor")
    keep = tile_keep(tile_ids, int(tile.max()) + 1)
    for j in torch.unique(tile).tolist():
        cols = torch.nonzero(tile == j)[:, 0]
        pts = torch.nonzero(keep[block, j])[:, 0]
        if pts.numel() == 0:
            continue
        w, idx = stjoin_ref(*(a[pts] for a in ref), *(a[cols] for a in cand),
                            eps_sp, eps_t)
        best_w[pts[:, None], cols] = w
        best_idx[pts[:, None], cols] = idx
    return best_w, best_idx


def _join(ref, cand, eps_sp, eps_t, tiles, **subset):
    """K1's plain sweep, or (``tiles`` given) the pruned one."""
    if tiles is None:
        return stjoin_ref(*ref, *cand, eps_sp, eps_t)
    tile_ids, bp, bc = tiles
    return stjoin_pruned_ref(*ref, *cand, tile_ids, eps_sp, eps_t, bp=bp,
                             bc=bc, **subset)


def run_refine(w, idx, ref_t, M: int, delta_t, *,
               chunk_elements: int = REFINE_ELEMENTS):
    """DTJ Refine on the flat contract (counterpart of ``_run_refine``).

    ``w [P, C]`` (0 = no match) and ``idx [P, C]`` (or ``None``) hold
    ``P = T * M`` reference points, whole rows of ``M`` points each;
    ``ref_t [P]``.  For each (row, candidate), a run is a maximal streak
    of consecutive matched points; a run whose time extent
    ``max(t) - min(t)`` is below ``delta_t`` is dropped (weight 0, index
    -1).  Equal to ``core.geometry.filter_delta_t`` on the ``[T, M, C]``
    view, which it runs in blocks of rows.  ``delta_t <= 0`` keeps every
    run and returns the inputs themselves.
    """
    if not float(delta_t) > 0.0:
        return w, idx
    P, C = w.shape
    T = P // M
    out_w = torch.empty_like(w)
    out_idx = None if idx is None else torch.empty_like(idx)
    rows = max(1, chunk_elements // max(M * C, 1))
    for t0 in range(0, T, rows):
        n = min(T, t0 + rows) - t0
        r = slice(t0 * M, (t0 + n) * M)
        bi = (torch.where(w[r] > 0.0, 0, -1).to(torch.int32) if idx is None
              else idx[r])
        j = filter_delta_t(JoinResult(best_w=w[r].view(n, M, C),
                                      best_idx=bi.view(n, M, C)),
                           ref_t[r].view(n, M), delta_t)
        out_w[r] = j.best_w.reshape(n * M, C)
        if out_idx is not None:
            out_idx[r] = j.best_idx.reshape(n * M, C)
    return out_w, out_idx


def vote_words_ref(w, with_words: bool = True):
    """The fused pass 1 consumers of refined weights ``w [P, C]``.

    ``vote [P]``: the sum over candidates in ascending order, one rounded
    add at a time from +0.0 (the order of the CUDA kernel; the Pallas
    kernel sums blocks of candidates first, so the two agree to ulps).
    ``words [P, ceil(C/32)]`` int32: bit c of word c // 32 set iff
    ``w[p, c] > 0`` (``None`` when ``with_words`` is false).
    """
    P, C = w.shape
    vote = torch.zeros((P,), dtype=torch.float32, device=w.device)
    for c0 in range(0, C, VOTE_COLUMNS):
        for col in w[:, c0:c0 + VOTE_COLUMNS].t().contiguous():
            vote.add_(col)
    words = pack_bits(w > 0.0, rows_per_chunk=PACK_ROWS) if with_words else None
    return vote, words


def stjoin_vote_fused_ref(ref_x, ref_y, ref_t, ref_id, ref_ok,
                          cand_x, cand_y, cand_t, cand_id, cand_ok,
                          eps_sp, eps_t, delta_t, *, M: int,
                          with_words: bool = True, tiles=None):
    """Fused pass 1: ``(vote [P] f32, words [P, ceil(C/32)] i32 | None)``
    for ``P = T * M`` reference points in whole rows of ``M``; with
    ``tiles``, K11's plain version."""
    w, _ = _join((ref_x, ref_y, ref_t, ref_id, ref_ok),
                 (cand_x, cand_y, cand_t, cand_id, cand_ok), eps_sp, eps_t,
                 tiles)
    w, _ = run_refine(w, None, ref_t, M, delta_t)
    return vote_words_ref(w, with_words)


def stjoin_sim_fused_ref(ref_x, ref_y, ref_t, ref_id, ref_ok, ref_gid,
                         cand_x, cand_y, cand_t, cand_id, cand_ok, cand_gid,
                         eps_sp, eps_t, delta_t, *, M: int, n_src: int,
                         n_dst: int, tiles=None):
    """Fused pass 2: the raw similarity scatter ``[n_src, n_dst]``
    (``ref_gid [P]``, ``cand_gid [C, Mc]``; the sentinels are ``n_src``
    and ``n_dst``); with ``tiles``, K12's plain version."""
    w, idx = _join((ref_x, ref_y, ref_t, ref_id, ref_ok),
                   (cand_x, cand_y, cand_t, cand_id, cand_ok), eps_sp, eps_t,
                   tiles)
    w, idx = run_refine(w, idx, ref_t, M, delta_t)
    T, C = ref_x.shape[0] // M, cand_x.shape[0]
    return scatter_raw(w.view(T, M, C), idx.view(T, M, C),
                       ref_gid.view(T, M), cand_gid, n_src, n_dst)


def stjoin_sim_panel_fused_ref(ref_x, ref_y, ref_t, ref_id, ref_ok, ref_gid,
                               cand_x, cand_y, cand_t, cand_id, cand_ok,
                               cand_gid, eps_sp, eps_t, delta_t, *, M: int,
                               n_src: int, n_dst: int, p0: int, panel: int,
                               tiles=None):
    """Panel pass 2: ``(fwd [panel, n_dst], rev [panel, n_src])`` with
    ``fwd[i, j] = raw[p0 + i, j]`` and ``rev[i, j] = raw[j, p0 + i]`` of
    ``stjoin_sim_fused_ref``'s ``raw``, bit for bit.

    Only the matches that reach the panel are computed: the reference rows
    that own a panel slot against every candidate (forward), and every
    reference row against the candidates that own one (reverse).  A
    (point, candidate) weight and its refine depend on nothing else, and
    each slab adds in ``scatter_raw``'s (t, m, c) order.  With ``tiles``,
    K13's plain version: each of the two joins sweeps only the planned
    pairs among its operands.
    """
    T, C = ref_x.shape[0] // M, cand_x.shape[0]
    gid = ref_gid.view(T, M)
    ref = (ref_x, ref_y, ref_t, ref_id, ref_ok)
    cand = (cand_x, cand_y, cand_t, cand_id, cand_ok)

    def join(ref_ops, cand_ops, rt, **subset):
        w, idx = _join(ref_ops, cand_ops, eps_sp, eps_t, tiles, **subset)
        return run_refine(w, idx, rt, M, delta_t)

    rows = panel_members(gid, p0, panel)
    pts = (rows[:, None] * M + torch.arange(M, device=rows.device)).view(-1)
    w, idx = join([a[pts] for a in ref], cand, ref_t[pts], ref_points=pts)
    fwd = scatter_raw(w.view(-1, M, C), idx.view(-1, M, C),
                      panel_local(gid[rows], p0, panel), cand_gid, panel,
                      n_dst)
    cols = panel_members(cand_gid, p0, panel)
    w, idx = join(ref, [a[cols] for a in cand], ref_t, cand_cols=cols)
    nc = cols.shape[0]
    rev = scatter_raw(w.view(T, M, nc), idx.view(T, M, nc), gid,
                      panel_local(cand_gid[cols], p0, panel), n_src, panel,
                      transpose=True)
    return fwd, rev


def chunk_time_bounds(t, ok, chunk: int):
    """``(lo, hi)`` ``[R, ceil(N / chunk)]`` f32: the min and max time over
    the valid points of each run of ``chunk`` consecutive points of each
    row of ``t [R, N]`` (NaN times count as invalid); ``(+inf, -inf)``
    where a run holds none.  The fused kernels (K2, K4, K7, K11-K13) take
    these of the candidates as their chunk bounds; the same reduction over groups of reference points
    gives the groups' bounds (``panel_skip_ref``)."""
    R, N = t.shape
    n = -(-N // chunk)
    pad = n * chunk - N
    keep = ok & ~torch.isnan(t)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=t.device)
    lo = torch.nn.functional.pad(torch.where(keep, t, inf), (0, pad),
                                 value=float("inf"))
    hi = torch.nn.functional.pad(torch.where(keep, t, -inf), (0, pad),
                                 value=float("-inf"))
    return (lo.view(R, n, chunk).amin(-1).contiguous(),
            hi.view(R, n, chunk).amax(-1).contiguous())


def panel_skip_ref(g_lo, g_hi, c_lo, c_hi, eps_t):
    """The time-window skip of the fused kernels, ``[..., groups, chunks]``
    bool: true where a group of reference points with time bounds ``(g_lo,
    g_hi) [..., G]`` and a chunk of candidate points with ``(c_lo, c_hi)
    [..., K]`` cannot hold a pair with ``|t_p - t_q| <= eps_t``: either
    holds no valid time (lo > hi), or ``c_lo - g_hi > eps_t``, or ``g_lo -
    c_hi > eps_t`` in f32, the rounded subtraction of the pair test.  A
    NaN bound makes every test false: it never skips."""
    eps = f32(eps_t, g_lo.device)
    gl, gh = g_lo[..., :, None], g_hi[..., :, None]
    cl, ch = c_lo[..., None, :], c_hi[..., None, :]
    return (gl > gh) | (cl > ch) | ((cl - gh) > eps) | ((gl - ch) > eps)


# (row, candidate) pairs per step of ``panel_skip_counts_ref``
_SKIP_ROWS = 16384


def panel_skip_counts_ref(ref_t, ref_ok, M: int, chunk_lo, chunk_hi, eps_t,
                          pairs, *, group: int):
    """``(swept, skipped)``: the (reference group, candidate chunk) pairs
    that the fused kernels test and those they skip over the (row t,
    candidate c) ``pairs [n, 2]`` they sweep, from the reference points'
    flat times ``ref_t`` / ``ref_ok`` (rows of ``M``, groups of ``group``
    consecutive points) and the candidates' chunk bounds.  The kernels'
    ``stats`` must equal these."""
    T = ref_t.shape[0] // M
    g_lo, g_hi = chunk_time_bounds(ref_t.view(T, M), ref_ok.view(T, M),
                                   group)
    pairs = pairs.long()
    n = pairs.shape[0]
    skipped = 0
    for s in range(0, n, _SKIP_ROWS):
        t, c = pairs[s:s + _SKIP_ROWS].unbind(1)
        skipped += int(panel_skip_ref(g_lo[t], g_hi[t], chunk_lo[c],
                                      chunk_hi[c], eps_t).sum())
    return n * g_lo.shape[1] * chunk_lo.shape[1], skipped
