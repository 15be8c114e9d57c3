"""PyTorch port: the plain mirrors of K3's and K9's schedules
(``kernels/jaccard/ref.py::jaccard_schedule_ref``,
``kernels/cluster/ref.py::topk_claim_max_schedule_ref``) held bit for bit
against the plain versions and the JAX package's Pallas kernels in
interpret mode, on seeded inputs at the shape edges the CUDA kernels
take: K3's column slabs (the launcher's and narrower ones), invalid rows
staged as zeros, windows wider than the row; K9's groups of 4 entries,
the tail cut at K, lanes a row from 1 to 32, tied weights and alpha
equal to an entry."""
import itertools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.cluster.cluster import topk_assign_pallas
from repro.kernels.jaccard.jaccard import jaccard_pallas
from repro_torch.core import segmentation as tseg
from repro_torch.kernels.cluster.ops import topk_cluster_assign
from repro_torch.kernels.cluster.ref import (claim_lanes,
                                             topk_claim_max_ref,
                                             topk_claim_max_schedule_ref)
from repro_torch.kernels.jaccard.ops import slab_plan, window_jaccard
from repro_torch.kernels.jaccard.ref import (jaccard_ref,
                                             jaccard_schedule_ref)

torch.set_num_threads(1)

# the card's opt-in shared-memory limit (H100): picks the launcher's slab
OPTIN = 232448


def _words(seed, T, M, W, p_valid=0.8):
    """Random packed words (about half the words zero, the rest any 32
    bits, bit 31 included) and validity; int32 bit patterns."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2 ** 32, (T, M, W), dtype=np.uint64).astype(
        np.uint32)
    w = np.where(rng.uniform(size=(T, M, W)) < 0.5, w, 0).astype(np.uint32)
    valid = rng.uniform(size=(T, M)) < p_valid
    return w, valid


K3_CASES = [(W, M, w if w != "M+3" else M + 3, False)
            for W, w, M in itertools.product([1, 7, 33, 128],
                                             [1, 7, 20, "M+3"], [1, 40, 130])]


@pytest.mark.parametrize("W,M,w,none", K3_CASES + [(33, 40, 7, True),
                                                   (128, 130, 20, True)])
def test_k3_schedule_mirror_matches(W, M, w, none):
    """The mirror, at the launcher's slab and at slabs of 4 (and, up to
    W = 33, 1) columns,
    bitwise: ``tsa2_signal`` (packed and bit-plane), the port's bit-
    expanded ``jaccard_ref``, the wrapper's plain path, and the JAX
    ``jaccard_pallas`` (interpret) on the masked words.  ``none``: every
    row invalid."""
    T = 3
    words, valid = _words(W * 1000 + M * 10 + w, T, M, W,
                          p_valid=0.0 if none else 0.8)
    masked = np.where(valid[..., None], words, 0).astype(np.uint32)
    tw = torch.from_numpy(words.view(np.int32))
    tm = torch.from_numpy(masked.view(np.int32))
    tv = torch.from_numpy(valid)
    want = tseg.tsa2_signal(tm, w)
    J = slab_plan(M, W, OPTIN)[0]
    for slab in sorted({J, 4, 1} if W <= 33 else {J, 4}):
        got = jaccard_schedule_ref(tw, tv, w, slab)
        assert torch.equal(got, want), slab
    assert torch.equal(tseg.tsa2_signal(tm, w, impl="bitplane"), want)
    assert torch.equal(window_jaccard(tw, tv, w=w), want)
    if W * M * w <= 33 * 130 * 133:
        assert torch.equal(jaccard_ref(tm, w), want)
    j = np.asarray(jaccard_pallas(jnp.asarray(masked), w=w, interpret=True))
    assert np.array_equal(j, want.numpy())
    if none:
        assert not bool(want.any())
    elif M > 1:
        assert bool((want > 0).any())


def test_k3_slab_plan():
    """The launcher's slab: 32 columns at dsc_brest / dsc_sis (M = 128),
    no wider than W needs, narrower as M grows, one column with the
    global scratch only past the opt-in limit."""
    assert slab_plan(128, 128, OPTIN) == (32, False)
    assert slab_plan(128, 256, OPTIN) == (32, False)
    assert slab_plan(130, 7, OPTIN) == (8, False)
    assert slab_plan(40, 1, OPTIN) == (1, False)
    assert slab_plan(300, 300, OPTIN) == (16, False)
    assert slab_plan(5000, 4, OPTIN) == (1, False)
    assert slab_plan(12000, 1, OPTIN) == (1, True)


def _lists(seed, S, K, tied=False, no_reps=False, p_valid=0.7):
    """Seeded [S, K] lists: ids with -1 padding (a row's tail, as the
    top-K lists pad, and scattered), weights in (0, 1] or from 4 values
    (``tied``), distinct ranks; alpha is one of the weights."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, S, (S, K)).astype(np.int32)
    deg = rng.integers(0, K + 1, S)
    ids[np.arange(K)[None, :] >= deg[:, None]] = -1
    ids[rng.uniform(size=(S, K)) < 0.1] = -1
    if tied:
        sims = (rng.integers(1, 5, (S, K)) / 4).astype(np.float32)
    else:
        sims = rng.uniform(0.0, 1.0, (S, K)).astype(np.float32)
    sims[ids < 0] = 0.0
    rank = rng.permutation(S).astype(np.int32)
    is_rep = (rng.uniform(size=S) < 0.3) & (not no_reps)
    valid = rng.uniform(size=S) < p_valid
    alpha = np.float32(sims[ids >= 0][0]) if (ids >= 0).any() else \
        np.float32(0.5)
    return ids, sims, rank, is_rep, valid, alpha


@pytest.mark.parametrize("case", ["plain", "tied", "no_reps", "invalid"])
@pytest.mark.parametrize("K", [1, 7, 32, 130])
def test_k9_schedule_mirror_matches(K, case):
    """The mirror (lanes a row from ``claim_lanes``, groups of 4 entries,
    the tail cut at K, the butterfly merge) bitwise ``topk_claim_max_ref``,
    the wrapper's plain path and the JAX ``topk_assign_pallas``
    (interpret), also at alpha 0 and at the largest weight."""
    S = 48
    ids, sims, rank, is_rep, valid, alpha = _lists(
        K * 10 + len(case), S, K, tied=case == "tied",
        no_reps=case == "no_reps", p_valid=0.0 if case == "invalid" else 0.7)
    t = [torch.from_numpy(a) for a in (ids, sims, rank, is_rep, valid)]
    claimed = []
    for a in (alpha, np.float32(0.0), np.float32(sims.max())):
        want = topk_claim_max_ref(*t, a)
        claimed.append(int((want[1] >= 0).sum()))
        got = topk_claim_max_schedule_ref(*t, a)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        wrap = topk_cluster_assign(*t, a)
        assert torch.equal(wrap[0], want[0]) and torch.equal(wrap[1],
                                                             want[1])
        jw, js = topk_assign_pallas(*(jnp.asarray(x) for x in
                                      (ids, sims, rank, is_rep, valid)),
                                    a, interpret=True)
        assert np.array_equal(np.asarray(jw), want[0].numpy())
        assert np.array_equal(np.asarray(js), want[1].numpy())
        if case in ("no_reps", "invalid"):
            assert not bool(want[0].any()) and bool((want[1] == -1).all())
    if case in ("plain", "tied"):
        assert claimed[1] > 0


def test_k9_claim_lanes():
    """Lanes a row: the least power of two covering ceil(K / 4) groups, at
    most 32 (4 rows a warp at K = 32, one at K >= 125)."""
    assert [claim_lanes(K) for K in (1, 4, 5, 7, 32, 33, 124, 125, 130,
                                     4096)] == [1, 1, 2, 2, 8, 16, 32, 32,
                                                32, 32]
