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
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.cluster.ops import cluster_assign as jax_assign
from repro.kernels.cluster.ops import cluster_round_scan as jax_round_scan
from repro_torch.kernels.cluster.ref import (claim_max_schedule_ref,
                                             cluster_assign_ref,
                                             round_scan_ref,
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
