"""PyTorch port: the clustering kernels and engines held against the JAX
package on seeded random ``[S, S]`` matrices, with tied weights and tied
voting.  Labels must be equal; alpha / k only to float32 rounding (the
vector sums run in another order than XLA's)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import clustering as jcl
from repro.core.types import DSCParams as JParams
from repro.core.types import SubtrajTable as JTable
from repro.kernels.cluster.cluster import assign_pallas, round_scan_pallas
from repro.kernels.cluster.ops import plan_tiles
from repro_torch.core import clustering as tcl
from repro_torch.core.types import DSCParams, SubtrajTable
from repro_torch.kernels.cluster.ops import cluster_assign, cluster_round_scan

torch.set_num_threads(1)

LABELS = ("member_of", "is_rep", "is_outlier")
PARAMS = [dict(alpha_sigma=0.0, k_sigma=0.0),
          dict(alpha_sigma=0.5, k_sigma=-0.5),
          dict(alpha_abs=0.2, k_abs=1.0),
          dict(alpha_abs=0.0, k_abs=0.0)]


def _instance(seed, S=40, tied=False):
    rng = np.random.default_rng(seed)
    raw = rng.uniform(0, 1, (S, S)).astype(np.float32)
    if tied:   # weights from a 4-value set: ties in every column
        raw = rng.integers(1, 5, (S, S)).astype(np.float32) / 4
    sim = raw * (rng.uniform(0, 1, (S, S)) > 0.5)
    sim = np.maximum(sim, sim.T).astype(np.float32)
    np.fill_diagonal(sim, 0.0)
    valid = rng.uniform(0, 1, S) > 0.1
    voting = (rng.integers(0, 3, S).astype(np.float32) if tied
              else rng.uniform(0, 5, S).astype(np.float32))
    card = rng.integers(1, 20, S).astype(np.int32)
    jt = JTable(t_start=jnp.zeros(S), t_end=jnp.ones(S),
                voting=jnp.asarray(voting), card=jnp.asarray(card),
                valid=jnp.asarray(valid),
                traj_row=jnp.arange(S, dtype=jnp.int32))
    tt = SubtrajTable(t_start=torch.zeros(S), t_end=torch.ones(S),
                      voting=torch.from_numpy(voting),
                      card=torch.from_numpy(card),
                      valid=torch.from_numpy(valid),
                      traj_row=torch.arange(S, dtype=torch.int32))
    return sim, jt, tt


def _state(seed, S):
    rng = np.random.default_rng(seed + 100)
    rank = rng.permutation(S).astype(np.int32)
    unres = rng.uniform(size=S) < 0.4
    rep = ~unres & (rng.uniform(size=S) < 0.5)
    valid = rng.uniform(size=S) < 0.9
    return rank, unres, rep, valid


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("seed,S", [(0, 40), (1, 128), (2, 200)])
def test_plain_k5_k6_match_pallas(seed, S, tied):
    sim, _, _ = _instance(seed, S, tied)
    rank, unres, rep, valid = _state(seed, S)
    alpha = np.float32(0.5)
    bu, bs, Sp = plan_tiles(S)
    pad = Sp - S
    sim_p = jnp.pad(jnp.asarray(sim), ((0, pad), (0, pad)))
    rank_p = jnp.concatenate([jnp.asarray(rank),
                              jnp.arange(S, Sp, dtype=jnp.int32)])
    padb = lambda v: jnp.pad(jnp.asarray(v), (0, pad))
    jb, jc = round_scan_pallas(sim_p, rank_p, padb(unres), padb(rep), alpha,
                               bu=bu, bs=bs, interpret=True)
    jw, js = assign_pallas(sim_p, rank_p, padb(rep), padb(valid), alpha,
                           bu=bu, bs=bs, interpret=True)
    ts = torch.from_numpy(sim)
    tr = torch.from_numpy(rank)
    tb, tc = cluster_round_scan(ts, tr, torch.from_numpy(unres),
                                torch.from_numpy(rep), alpha)
    tw, tsl = cluster_assign(ts, tr, torch.from_numpy(rep),
                             torch.from_numpy(valid), alpha)
    assert np.array_equal(np.asarray(jb)[:S], tb.numpy())
    assert np.array_equal(np.asarray(jc)[:S], tc.numpy())
    assert np.array_equal(np.asarray(jw)[:S], tw.numpy())
    assert np.array_equal(np.asarray(js)[:S], tsl.numpy())
    assert tb.any() and tsl.ge(0).any()


def _assert_labels(jres, tres, tol_alpha=1e-6, tol_k=1e-5):
    for f in LABELS:
        assert np.array_equal(np.asarray(getattr(jres, f)),
                              getattr(tres, f).numpy()), f
    # member_sim holds matrix entries (or inf): equal bit for bit
    assert np.array_equal(np.asarray(jres.member_sim),
                          tres.member_sim.numpy())
    np.testing.assert_allclose(float(tres.alpha_used),
                               float(jres.alpha_used), rtol=0,
                               atol=tol_alpha)
    np.testing.assert_allclose(float(tres.k_used), float(jres.k_used),
                               rtol=0, atol=tol_k)


@pytest.mark.parametrize("params", range(len(PARAMS)))
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_engines_match_reference(seed, tied, params):
    sim, jt, tt = _instance(seed, 48, tied)
    kw = PARAMS[params]
    jref = jcl.cluster_sequential(jnp.asarray(sim), jt, JParams(**kw))
    tsim = torch.from_numpy(sim)
    p = DSCParams(**kw)
    seq = tcl.cluster_sequential(tsim, tt, p)
    rounds, n = tcl.cluster_rounds(tsim, tt, p, with_rounds=True)
    kern = tcl.cluster_rounds(tsim, tt, p, use_kernel=True)
    _, jn = jcl.cluster_rounds(jnp.asarray(sim), jt, JParams(**kw),
                                     with_rounds=True)
    for res in (seq, rounds, kern):
        _assert_labels(jref, res)
    assert n == int(jn)


def test_visit_order_is_stable():
    voting = torch.tensor([1.0, 2.0, 2.0, 1.0, 0.5, 2.0])
    valid = torch.tensor([True, True, False, True, True, True])
    t = SubtrajTable(t_start=torch.zeros(6), t_end=torch.zeros(6),
                     voting=voting, card=torch.ones(6, dtype=torch.int32),
                     valid=valid, traj_row=torch.arange(6, dtype=torch.int32))
    order, rank = tcl.visit_order(t)
    assert order.tolist() == [1, 5, 0, 3, 4, 2]
    assert rank[order.long()].tolist() == list(range(6))


def test_scores_match_reference():
    sim, jt, tt = _instance(5, 48)
    kw = PARAMS[1]
    jres = jcl.cluster_rounds(jnp.asarray(sim), jt, JParams(**kw))
    tres = tcl.cluster_rounds(torch.from_numpy(sim), tt, DSCParams(**kw))
    np.testing.assert_allclose(float(tcl.sscr(tres, torch.from_numpy(sim))),
                               float(jcl.sscr(jres, jnp.asarray(sim))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(tcl.rmse(tres, torch.from_numpy(sim), 0.3)),
        float(jcl.rmse(jres, jnp.asarray(sim), 0.3)), rtol=1e-6)
