"""PyTorch port: the plain mirrors of K5's and K6's schedules held against
the contract.

``round_scan_schedule_ref`` walks the round scan as the CUDA kernel does
(row slices, each compacted to its active rows in row order, read a group
of ``SCAN_UNROLL`` rows at a time over groups of 4 columns, the last group
cut at an unaligned ``S``).  On seeded
numpy matrices it must give the blocked / claimed vectors of the plain
version ``round_scan_ref`` and of the JAX package's ``round_scan_pallas``
(interpret mode, through its padding wrapper).  The outputs are boolean:
equal, no tolerance.

``claim_max_schedule_ref`` walks K6's claim-max as its kernel does (the
representative rows listed in row order, the list cut into slices, each
slice's running maximum merged in slice order).  It must give the
weights, bit for bit, and the slots of K6's plain twin
``cluster_assign_ref`` and of the JAX package's ``cluster_assign``
(interpret mode) for any int32 ranks and any number of representatives.

``moments_schedule`` walks the row moments' kernel (``sim_row_moments``,
K16: groups of 4 columns, a 32-lane butterfly, sweeps of 512 columns
joined by a binary counter).  Its count, sum and sum of squares must equal,
bit for bit, the plain version's fixed pairwise tree and the JAX
package's ``sim_row_moments``, at row lengths from 0 to 32,768, on values
that differ by orders of magnitude (so that any other grouping of the
additions would round differently).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.cluster.ops import cluster_assign as jax_assign
from repro.kernels.cluster.ops import cluster_round_scan as jax_round_scan
from repro.core.similarity import sim_row_moments as jax_moments
from repro_torch.core.similarity import sim_row_moments
from repro_torch.kernels.cluster.ops import sim_row_moments as k16_moments
from repro_torch.kernels.cluster.ref import (claim_max_schedule_ref,
                                             cluster_assign_ref,
                                             round_scan_ref,
                                             sim_row_moments_ref,
                                             round_scan_schedule_ref)

torch.set_num_threads(1)


def _matrix(S, seed, tied):
    """A symmetric matrix with about half its entries 0; ``tied`` draws the
    rest from {0.25, 0.5, 0.75, 1} (ties in every column)."""
    rng = np.random.default_rng(seed)
    vals = (rng.integers(1, 5, (S, S)) / 4 if tied
            else rng.uniform(0, 1, (S, S)))
    sim = (vals * (rng.uniform(size=(S, S)) > 0.5)).astype(np.float32)
    sim = np.maximum(sim, sim.T)
    np.fill_diagonal(sim, 0.0)
    return sim, rng.permutation(S).astype(np.int32), rng


def _state(rng, S, kind):
    """(unresolved, is_rep): a round's mix, every row active (some with
    both flags, which the kernel takes though the engine never sets it) or
    none."""
    if kind == "none":
        return np.zeros(S, bool), np.zeros(S, bool)
    unres = rng.uniform(size=S) < (0.5 if kind == "all" else 0.4)
    if kind == "all":
        return unres, ~unres | (rng.uniform(size=S) < 0.2)
    return unres, ~unres & (rng.uniform(size=S) < 0.5)


# name: (tied, state, wide); alpha is a matrix entry in every case, so
# entries equal to alpha must count as alpha-edges; ``wide`` spreads the
# ranks over the whole int32 range, order kept (the wrapper takes any
# int32 rank, as round_scan_pallas does)
CASES = {"random": (False, "mixed", False), "tied": (True, "mixed", False),
         "all_active": (True, "all", False),
         "none_active": (False, "none", False),
         "wide_ranks": (False, "mixed", True)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("S", [8, 130, 257, 513, 1030])
def test_schedule_mirror_matches(S, case):
    tied, kind, wide = CASES[case]
    sim, rank, rng = _matrix(S, S + len(case), tied)
    if wide:
        rank = ((rank.astype(np.int64) - S // 2) * (2 ** 31 // S)
                ).astype(np.int32)
        assert np.abs(rank).max() >= 2 ** 29
    unres, rep = _state(rng, S, kind)
    nz = sim[sim > 0]
    alpha = np.float32(0.5 if tied else nz[len(nz) // 2])
    t = [torch.from_numpy(a) for a in (sim, rank, unres, rep)]
    want = round_scan_ref(*t, alpha)
    jb, jc = jax_round_scan(*(jnp.asarray(a) for a in (sim, rank, unres,
                                                        rep)),
                            alpha, interpret=True)
    assert np.array_equal(np.asarray(jb), want[0].numpy())
    assert np.array_equal(np.asarray(jc), want[1].numpy())
    # 16: the kernel's slices at S = 32768 on 132 SMs
    for n_split in (1, 3, 16):
        got = round_scan_schedule_ref(*t, alpha, n_split)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if kind == "none":
        assert not want[0].any() and not want[1].any()
    else:
        assert want[0].any()



# representatives: none, one, 8 (dsc_brest's final count), half, all
REPS = {"none": 0, "one": 1, "eight": 8, "half": 0.5, "all": 1.0}


@pytest.mark.parametrize("reps", sorted(REPS))
@pytest.mark.parametrize("ranks", ["perm", "dup", "wide"])
@pytest.mark.parametrize("S", [130, 257])
def test_claim_max_schedule_mirror_matches(S, ranks, reps):
    sim, rank, rng = _matrix(S, S + len(ranks) + len(reps), True)
    if ranks == "dup":
        rank = rng.integers(0, 8, S).astype(np.int32)
    elif ranks == "wide":    # 2^31 - 1 excluded: the reference's sentinel
        rank = rng.integers(-2 ** 31, 2 ** 31 - 1, S).astype(np.int32)
    n = REPS[reps]
    n = int(n * S) if isinstance(n, float) else n
    rep = np.zeros(S, bool)
    rep[rng.permutation(S)[:n]] = True
    valid = rng.uniform(size=S) < 0.9
    t = [torch.from_numpy(a) for a in (sim, rank, rep, valid)]
    want = cluster_assign_ref(*t, 0.5)
    jw, js = jax_assign(*(jnp.asarray(a) for a in (sim, rank, rep, valid)),
                        np.float32(0.5), interpret=True)
    assert np.array_equal(np.asarray(jw).view(np.int32),
                          want[0].numpy().view(np.int32))
    assert np.array_equal(np.asarray(js), want[1].numpy())
    # 1 to 16 slices: "half" and "all" cut the list into 3 and 5-9 of them
    for n_split in (1, 3, 16):
        got = claim_max_schedule_ref(*t, 0.5, n_split)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((want[1] >= 0).any()) == (n > 0)


def moments_schedule(sim, row_valid, col_valid, sweep=512):
    """The row moments in the kernel's order of additions, every row at
    once: each group of 4 columns as (a + b) + (c + d); a butterfly over
    32 lanes (lane l holds the group at 4 l of each 128-column block) to
    the block's sum; 4 blocks as (b0 + b1) + (b2 + b3), one sweep; the
    sweeps joined by a binary counter, then its pending blocks from the
    lowest level up."""
    R, N = sim.shape
    pos = (sim > 0.0) & row_valid[:, None] & col_valid[None, :]
    x = torch.where(pos, sim, 0.0)
    n_sw = -(-N // sweep)
    swap = {off: torch.arange(32) ^ off for off in (1, 2, 4, 8, 16)}
    out = [pos.sum(1, dtype=torch.int32)]
    for v in (x, x * x):
        v = torch.nn.functional.pad(v, (0, n_sw * sweep - N))
        v = v.view(R, n_sw, sweep // 128, 32, 4)
        g = (v[..., 0] + v[..., 1]) + (v[..., 2] + v[..., 3])
        for idx in swap.values():
            g = g + g[..., idx]
        assert torch.equal(g, g[..., :1].expand_as(g))   # every lane alike
        b = g[..., 0]
        blocks = (b[..., 0] + b[..., 1]) + (b[..., 2] + b[..., 3])
        pending = {}
        for k in range(n_sw):
            blk, level = blocks[:, k], 0
            while (k >> level) & 1:
                blk = pending[level] + blk
                level += 1
            pending[level] = blk
        total = torch.zeros(R)
        for level in range(31):
            if (n_sw >> level) & 1:
                total = pending[level] + total
        out.append(total)
    return tuple(out)


def moments_input(R, N, seed, wide):
    """A sparse ``[R, N]`` float32 matrix (about 30% positive entries, exact
    zeros, 2% negative ones) and row / column masks with about 10% false;
    ``wide`` spreads the positive values over 1e-15 .. 1e15."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.0, 1.0, (R, N))
    if wide:
        vals = (vals + 0.5) * 10.0 ** rng.integers(-15, 16, (R, N))
    sim = np.where(rng.uniform(size=(R, N)) < 0.3, vals, 0.0)
    sim[rng.uniform(size=(R, N)) < 0.02] = -0.5
    return (sim.astype(np.float32), rng.uniform(size=R) < 0.9,
            rng.uniform(size=N) < 0.9)


# row lengths: under one group, one sweep, 3 and 5 sweeps (pending blocks
# at two levels), a power of two, one past it, dsc_brest's S
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("N", [0, 1, 7, 128, 1536, 2560, 4096, 4097,
                               32768])
def test_moments_schedule_mirror_matches(N, wide):
    R = 5 if N > 4097 else 24
    arrays = moments_input(R, N, N + wide, wide)
    t = [torch.from_numpy(a) for a in arrays]
    want = sim_row_moments_ref(*t)
    got = moments_schedule(*t)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    jm = jax_moments(*(jnp.asarray(a) for a in arrays))
    for j, w in zip(jm, want):
        assert np.array_equal(np.asarray(j), w.numpy())
    # CPU tensors: the wrapper and either plan take the plain tree
    for got in (k16_moments(*t), sim_row_moments(*t),
                sim_row_moments(*t, use_kernel=True)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(want[0].sum()) > 0 or N < 8
