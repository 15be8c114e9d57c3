"""PyTorch port: the clustering kernels and engines held against the JAX
package on seeded random ``[S, S]`` matrices, with tied weights and tied
voting.  Labels must be equal; alpha / k only to float32 rounding (the
vector sums run in another order than XLA's)."""
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import clustering as jcl
from repro.core.types import DSCParams as JParams
from repro.core.types import SubtrajTable as JTable
from repro.kernels.cluster.cluster import assign_pallas, round_scan_pallas
from repro.kernels.cluster.ops import cluster_assign as jax_assign
from repro.kernels.cluster.ops import plan_tiles
from repro_torch.core import clustering as tcl
from repro_torch.core.types import DSCParams, SubtrajTable, TopKSim
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


@functools.lru_cache(maxsize=None)
def _fig1_instance():
    """fig1's matrix from the reference's ``run_dsc``, its weights rounded
    up to quarters (ties in every column), and its table's ``valid``."""
    (jsim, jt, _), _ = _dsc_inputs("fig1", "dense")
    sim = np.ceil(np.asarray(jsim) * 4).astype(np.float32) / 4
    return sim, np.array(jt.valid)


# rank kinds: a permutation (the visit order's), duplicates from 8 values,
# and ranks spread over the int32 range (2^31 - 1 excluded: it is the
# reference's sentinel for "no candidate", ref.py::cluster_assign_ref)
RANKS = {"perm": lambda rng, S: rng.permutation(S),
         "dup": lambda rng, S: rng.integers(0, 8, S),
         "wide": lambda rng, S: rng.integers(-2 ** 31, 2 ** 31 - 1, S)}


@pytest.mark.parametrize("ranks", sorted(RANKS))
@pytest.mark.parametrize("instance", ["fig1", "rand40", "rand200"])
def test_plain_k6_any_ranks_match_pallas(instance, ranks):
    """``cluster_assign`` on the CPU (K6's plain twin) against the
    reference's ``cluster_assign`` (interpret mode) for any int32 ranks:
    ``best_w`` bit for bit, ``best_slot`` equal, ties in weight and (for
    duplicate ranks) in weight and rank going to the lowest row."""
    if instance == "fig1":
        sim, valid = _fig1_instance()
        rng = np.random.default_rng(7)
    else:
        S = int(instance[4:])
        sim, _, _ = _instance(S, S, tied=True)
        rng = np.random.default_rng(S + 1)
        valid = rng.uniform(size=S) < 0.9
    S = sim.shape[0]
    rank = RANKS[ranks](rng, S).astype(np.int32)
    rep = rng.uniform(size=S) < 0.3
    alpha = np.float32(0.5)
    jw, js = jax_assign(*(jnp.asarray(a) for a in (sim, rank, rep, valid)),
                        alpha, interpret=True)
    t = [torch.from_numpy(a) for a in (sim, rank, rep, valid)]
    tw, ts = cluster_assign(*t, alpha)
    assert np.array_equal(np.asarray(jw).view(np.int32),
                          tw.numpy().view(np.int32))
    assert np.array_equal(np.asarray(js), ts.numpy())
    # the columns whose winner was decided by the weight tie-break (and,
    # for duplicates, by the row tie-break too): the instance reaches both
    claim = rep[:, None] & valid[None, :] & (sim > 0) & (sim >= alpha)
    w = np.where(claim, sim, 0)
    top = claim & (w == w.max(0)) & (w.max(0) > 0)
    assert (top.sum(0) > 1).any()
    if ranks == "dup":
        rk = np.where(top, rank[:, None], 2 ** 31 - 1)
        assert ((top & (rk == rk.min(0))).sum(0) > 1).any()


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


def _dsc_inputs(scenario, sim_mode):
    """The reference's similarity (dense matrix or top-K lists), table
    and parameters after its ``run_dsc`` on fig1 or ``ais_like``, handed
    to both packages as the same numpy arrays."""
    from repro.core import dsc as jdsc
    from repro.data import synthetic as jsyn
    if scenario == "fig1":
        jb = jsyn.figure1_scenario(n_per_route=4, points_per_leg=24,
                                   seed=0)[0]
        kw = dict(eps_sp=0.42, eps_t=1.0, w=6, tau=0.15)
    else:
        jb = jsyn.ais_like(n_vessels=24, max_points=96, seed=1)[0]
        diam, mean_dt = jsyn.default_dsc_params_for(jb)
        kw = dict(eps_sp=0.15 * diam, eps_t=mean_dt, w=12, tau=0.4)
    kw.update(delta_t=0.0, alpha_sigma=-1.0, k_sigma=-1.0,
              segmentation="tsa2")
    jo = jdsc.run_dsc(jb, JParams(**kw), sim_mode=sim_mode)
    as_t = lambda cls, obj: cls(**{
        f: torch.from_numpy(np.array(getattr(obj, f)))
        for f in cls.__dataclass_fields__})
    if sim_mode == "dense":
        jsim, tsim = jo.sim, torch.from_numpy(np.array(jo.sim))
    else:
        jsim, tsim = jo.sim_topk, as_t(TopKSim, jo.sim_topk)
    return (jsim, jo.table, JParams(**kw)), (tsim, as_t(SubtrajTable,
                                                         jo.table),
                                             DSCParams(**kw))


@pytest.mark.parametrize("sim_mode", ["dense", "topk"])
@pytest.mark.parametrize("scenario", ["fig1", "ais"])
def test_max_rounds_matches_reference(scenario, sim_mode):
    """``max_rounds=`` on ``cluster`` (both engines, plain and kernel
    plans): the fixed trip of S rounds gives the reference's labels and
    the rounds of the default loop; ``max_rounds < S`` is refused with the
    reference's message, word for word, by ``cluster``,
    ``cluster_rounds`` and ``cluster_rounds_topk``."""
    (jsim, jt, jp), (tsim, tt, tp) = _dsc_inputs(scenario, sim_mode)
    S = tt.num_slots
    jres = jcl.cluster(jsim, jt, jp, max_rounds=S)
    _, jn = (jcl.cluster_rounds if sim_mode == "dense"
             else jcl.cluster_rounds_topk)(jsim, jt, jp, with_rounds=True)
    for use_kernel in (False, True):
        tres, n = tcl.cluster(tsim, tt, tp, max_rounds=S,
                              use_kernel=use_kernel, with_rounds=True)
        _assert_labels(jres, tres)
        assert n == int(jn) >= 1
    _assert_labels(jres, tcl.cluster(tsim, tt, tp, engine="sequential",
                                     max_rounds=S))
    with pytest.raises(ValueError) as jerr:
        jcl.cluster(jsim, jt, jp, max_rounds=S - 1)
    engine = (tcl.cluster_rounds if sim_mode == "dense"
              else tcl.cluster_rounds_topk)
    for fn in (tcl.cluster, engine):
        with pytest.raises(ValueError) as terr:
            fn(tsim, tt, tp, max_rounds=S - 1)
        assert str(terr.value) == str(jerr.value)


@functools.lru_cache(maxsize=None)
def _cached_inputs(scenario, sim_mode):
    return _dsc_inputs(scenario, sim_mode)


TILES = [None, (8, 128), (16, 256), (8, 8)]


@pytest.mark.parametrize("tiles", TILES, ids=str)
@pytest.mark.parametrize("sim_mode", ["dense", "topk"])
@pytest.mark.parametrize("scenario", ["fig1", "ais"])
def test_tiles_match_reference(scenario, sim_mode, tiles):
    """A reference call with ``tiles=(bu, bs)`` runs unchanged on the
    port: ``cluster``, and the engine it dispatches to, with the kernel
    plan and with the plain one, give the labels (and ``member_sim``) of
    the reference's Pallas engine at the same tiles, and of the port's
    own run without ``tiles=``."""
    (jsim, jt, jp), (tsim, tt, tp) = _cached_inputs(scenario, sim_mode)
    jres = jcl.cluster(jsim, jt, jp, use_kernel=True, tiles=tiles)
    base = tcl.cluster(tsim, tt, tp, use_kernel=True)
    engine = (tcl.cluster_rounds if sim_mode == "dense"
              else tcl.cluster_rounds_topk)
    for tres in (tcl.cluster(tsim, tt, tp, use_kernel=True, tiles=tiles),
                 engine(tsim, tt, tp, use_kernel=True, tiles=tiles),
                 tcl.cluster(tsim, tt, tp, tiles=tiles)):
        _assert_labels(jres, tres)
        for f in LABELS + ("member_sim",):
            assert torch.equal(getattr(tres, f), getattr(base, f)), f


@pytest.mark.parametrize("bad", [(8,), (8, 128, 1), (0, 128), (8, -1),
                                 (8.0, 128), "8,128", 8, (8, None)], ids=str)
def test_malformed_tiles_are_refused(bad):
    """What the reference's Pallas engine cannot run (anything but a pair
    of positive ints) the port refuses, naming the argument, in every
    entry point and engine."""
    (jsim, jt, jp), (tsim, tt, tp) = _cached_inputs("fig1", "dense")
    with pytest.raises(Exception):
        jcl.cluster(jsim, jt, jp, use_kernel=True, tiles=bad)
    (_, _, _), (ttopk, _, _) = _cached_inputs("fig1", "topk")
    calls = [(tcl.cluster, tsim), (tcl.cluster_rounds, tsim),
             (tcl.cluster_rounds_topk, ttopk), (tcl.cluster, ttopk)]
    for fn, sim in calls:
        for use_kernel in (False, True):
            with pytest.raises(ValueError, match="tiles"):
                fn(sim, tt, tp, use_kernel=use_kernel, tiles=bad)
    with pytest.raises(ValueError, match="tiles"):
        tcl.cluster(tsim, tt, tp, engine="sequential", tiles=bad)


@pytest.mark.parametrize("S", [1, 40, 128, 200, 4097])
def test_plan_tiles_is_the_reference(S):
    from repro_torch.kernels.cluster.ops import plan_tiles as tplan
    for bu, bs in ((8, 128), (16, 256), (8, 8), (3, 5), (1, 1)):
        assert tplan(S, bu, bs) == plan_tiles(S, bu, bs)
    assert tplan(S) == plan_tiles(S)


def test_cluster_wrappers_take_the_reference_knobs():
    """The four wrappers take the reference's ``bu`` / ``bs`` /
    ``interpret`` with its defaults; the reference's outputs are bitwise
    the same at every geometry, and so are the port's (ignored); a tile
    no Pallas grid could run is refused."""
    from repro_torch.kernels.cluster import ops
    sim, _, _ = _instance(6, 40, tied=True)
    rank, unres, rep, valid = (torch.from_numpy(a) for a in _state(6, 40))
    sim = torch.from_numpy(sim)
    sims, ids = torch.topk(sim, 7, dim=1, sorted=True)
    ids = ids.to(torch.int32)
    cases = [
        (ops.cluster_round_scan, (sim, rank, unres, rep, 0.5), "bu"),
        (ops.cluster_assign, (sim, rank, rep, valid, 0.5), "bu"),
        (ops.topk_cluster_round_scan, (ids, sims, rank, unres, rep, 0.5),
         None),
        (ops.topk_cluster_assign, (ids, sims, rank, rep, valid, 0.5), None)]
    for fn, args, has_bu in cases:
        base = fn(*args)
        knobs = [dict(bs=256, interpret=False), dict(bs=3, interpret=True)]
        if has_bu:
            knobs += [dict(bu=16, bs=256), dict(bu=1, bs=1)]
        for kw in knobs:
            got = fn(*args, **kw)
            assert all(torch.equal(g, b) for g, b in zip(got, base)), kw
        with pytest.raises(ValueError, match="bs must be a positive int"):
            fn(*args, bs=0)
        if has_bu:
            with pytest.raises(ValueError, match="bu must be a positive"):
                fn(*args, bu=-8)
