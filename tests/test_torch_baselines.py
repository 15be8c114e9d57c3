"""PyTorch port: the baselines and the evaluation metrics held against the
JAX package, on ``tests/test_baselines.py``'s two inputs (``small_fig1``
and the ``crossing_scenario`` of its ``test_fig7_rmse_ordering``).

TraClus, T-OPTICS and every evaluation function are the reference's numpy
code on the same float32 arrays: integers equal, floats equal (tolerance
0).  S2T's voting, segmentation and similarity run the port's plain DSC
core: labels equal; ``sim`` and ``member_sim`` within 1e-5 absolute, the
tolerance ``tests/test_torch_fused.py`` states for per-cell sums in
another order than XLA's (measured here: 0).  The Fig. 7 RMSE ordering
holds for the port as for the reference.
"""
import numpy as np
import pytest
import torch

from repro.core import evaluation as jev
from repro.core.baselines import s2t as js2t
from repro.core.baselines import toptics as jto
from repro.core.baselines import traclus as jtc
from repro.core.dsc import run_dsc as jrun_dsc
from repro.core.types import DSCParams as JParams
from repro.data import synthetic as jsyn
from repro_torch.core import evaluation as tev
from repro_torch.core.baselines import s2t as ts2t
from repro_torch.core.baselines import toptics as tto
from repro_torch.core.baselines import traclus as ttc
from repro_torch.core.dsc import run_dsc
from repro_torch.core.types import DSCParams
from repro_torch.data import synthetic as tsyn

torch.set_num_threads(1)

ATOL = 1e-5
EPS_SP = 0.42
# test_fig7_rmse_ordering's DSC parameters
FIG7 = dict(eps_sp=EPS_SP, eps_t=1.0, delta_t=6.0, w=5, tau=0.2,
            alpha_sigma=0.0, k_sigma=-1.0, segmentation="tsa1")
SCENARIOS = ["small_fig1", "crossing"]


def _batches(name):
    if name == "small_fig1":
        jb, label = jsyn.figure1_scenario(n_per_route=3, points_per_leg=16,
                                          seed=2)
        tb, tlabel = tsyn.figure1_scenario(n_per_route=3, points_per_leg=16,
                                           seed=2, device="cpu")
    else:
        jb, label, _ = jsyn.crossing_scenario(n_per_route=3,
                                              points_per_leg=16,
                                              n_crossers=4, seed=2)
        tb, tlabel, _ = tsyn.crossing_scenario(n_per_route=3,
                                               points_per_leg=16,
                                               n_crossers=4, seed=2,
                                               device="cpu")
    assert np.array_equal(label, tlabel)
    for f in ("x", "y", "t", "valid", "traj_id"):
        assert np.array_equal(np.asarray(getattr(jb, f)),
                              getattr(tb, f).numpy()), f
    return jb, tb, label


@pytest.fixture(scope="module")
def runs():
    """Per scenario: the batches, both packages' TraClus and S2T (the
    expensive baselines, run once), and both DSC runs at FIG7."""
    out = {}
    for name in SCENARIOS:
        jb, tb, label = _batches(name)
        jo = jrun_dsc(jb, JParams(**FIG7))
        to = run_dsc(tb, DSCParams(**FIG7), device="cpu")
        n_reps = int(to.result.is_rep.sum())
        assert n_reps == int(np.asarray(jo.result.is_rep).sum())
        s2t_kw = dict(eps_sp=EPS_SP, eps_t=1.0, w=5, tau=0.2, n_reps=n_reps)
        out[name] = dict(
            jb=jb, tb=tb, label=label, jo=jo, to=to,
            jtc=jtc.traclus(jb, eps=0.35, min_lns=3),
            ttc=ttc.traclus(tb, eps=0.35, min_lns=3),
            js2t=js2t.s2t_clustering(jb, **s2t_kw),
            ts2t=ts2t.s2t_clustering(tb, **s2t_kw))
    return out


@pytest.mark.parametrize("name", SCENARIOS)
def test_traclus_matches_reference(runs, name):
    j, t = runs[name]["jtc"], runs[name]["ttc"]
    assert len(t["segments"]) == len(j["segments"]) > 0
    for (a, b), (c, d) in zip(t["segments"], j["segments"]):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    assert np.array_equal(t["labels"], j["labels"])
    assert np.array_equal(t["seg_traj"], j["seg_traj"])
    assert len(t["reps"]) == len(j["reps"]) == t["labels"].max() + 1
    for a, b in zip(t["reps"], j["reps"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", SCENARIOS)
def test_s2t_matches_reference(runs, name):
    j, t = runs[name]["js2t"], runs[name]["ts2t"]
    for f in ("member_of", "is_rep", "is_outlier"):
        assert np.array_equal(t[f], j[f]), f
    np.testing.assert_allclose(t["member_sim"], j["member_sim"], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(t["sim"], j["sim"], rtol=0, atol=ATOL)
    for f in ("cut", "sub_local", "num_subs"):
        assert np.array_equal(getattr(t["seg"], f).numpy(),
                              np.asarray(getattr(j["seg"], f))), f
    assert np.array_equal(t["table"].valid.numpy(),
                          np.asarray(j["table"].valid))
    assert t["is_rep"].sum() > 0
    members = (t["member_of"] >= 0) & ~t["is_rep"]
    assert members.sum() > 0 and t["is_rep"][t["member_of"][members]].all()


@pytest.mark.parametrize("eps,min_pts,xi_eps", [(2.0, 3, 0.2),
                                                (0.5, 3, None)])
@pytest.mark.parametrize("name", SCENARIOS)
def test_t_optics_matches_reference(runs, name, eps, min_pts, xi_eps):
    """The fig6 benchmark's parameters, and the default extraction."""
    j = jto.t_optics(runs[name]["jb"], eps=eps, min_pts=min_pts,
                     xi_eps=xi_eps)
    t = tto.t_optics(runs[name]["tb"], eps=eps, min_pts=min_pts,
                     xi_eps=xi_eps)
    for f in ("labels", "order", "reach", "D"):
        assert np.array_equal(t[f], j[f]), f
    assert (t["labels"] >= 0).any()


@pytest.mark.parametrize("name", SCENARIOS)
def test_evaluation_matches_reference(runs, name):
    """Every function of ``core.evaluation`` on the same clusterings: the
    port's takes its tensors (moved to the host), the reference's its
    arrays."""
    r = runs[name]
    jb, tb, jo, to = r["jb"], r["tb"], r["jo"], r["to"]
    ms = DSCParams(**FIG7).max_subtrajs_per_traj
    jres, tres = jo.result, to.result
    jsub, tsub = np.asarray(jo.seg.sub_local), to.seg.sub_local
    for eps_t in (None, 1.0):
        assert tev.rmse_subtraj(tb, tsub, tres.member_of, tres.is_rep, ms,
                                eps_t) == jev.rmse_subtraj(
            jb, jsub, np.asarray(jres.member_of), np.asarray(jres.is_rep),
            ms, eps_t)
    # the same matrix, member_of and is_rep through both
    sim = to.sim.numpy()
    mo, ir = tres.member_of.numpy(), tres.is_rep.numpy()
    assert tev.rmse_sim_based(to.sim, tres.member_of, tres.is_rep,
                              EPS_SP) == jev.rmse_sim_based(sim, mo, ir,
                                                            EPS_SP)
    for eps in (None, EPS_SP):
        assert tev.rmse_traclus(r["ttc"], eps) == jev.rmse_traclus(
            r["jtc"], eps)
    # the crossing scenario's extra rows (label -1) get a route "X"
    label = r["label"]
    origins, dests = jsyn.route_origins_dests(np.maximum(label, 0))
    origins = np.where(label >= 0, origins, "X")
    dests = np.where(label >= 0, dests, "X")
    t_split = float(np.asarray(jb.t)[np.asarray(jb.valid)].max()) / 2
    jtruth = jev.leg_labels(jb, jsub, origins, dests, t_split, ms)
    ttruth = tev.leg_labels(tb, tsub, origins, dests, t_split, ms)
    assert ttruth == jtruth and ttruth
    assign = {int(s): int(s) if ir[s] else int(mo[s])
              for s in np.nonzero(to.table.valid.numpy())[0]
              if ir[s] or mo[s] >= 0}
    assert tev.cluster_purity(assign, ttruth) == jev.cluster_purity(
        assign, jtruth)
    assert tev.pairwise_f1(assign, ttruth) == jev.pairwise_f1(assign,
                                                              jtruth)


def test_fig7_rmse_ordering(runs):
    """Port of ``tests/test_baselines.py::test_fig7_rmse_ordering``: DSC <=
    S2T <= TraClus in intra-cluster RMSE (paper Fig. 7), and each RMSE
    within 1e-5 relative of the reference's (DSC's and S2T's matrices
    agree to ulps)."""
    r = runs["crossing"]
    out = r["to"]
    r_dsc = tev.rmse_sim_based(out.sim, out.result.member_of,
                               out.result.is_rep, EPS_SP)
    s2t = r["ts2t"]
    r_s2t = tev.rmse_sim_based(s2t["sim"], s2t["member_of"], s2t["is_rep"],
                               EPS_SP)
    r_tc = tev.rmse_traclus(r["ttc"], eps_sp=EPS_SP)
    assert r_dsc > 0 and r_s2t > 0 and r_tc > 0
    assert r_dsc <= r_s2t * 1.02, (r_dsc, r_s2t)
    assert r_s2t <= r_tc * 1.25, (r_s2t, r_tc)
    jo, js = r["jo"], r["js2t"]
    want = (jev.rmse_sim_based(np.asarray(jo.sim),
                               np.asarray(jo.result.member_of),
                               np.asarray(jo.result.is_rep), EPS_SP),
            jev.rmse_sim_based(js["sim"], js["member_of"], js["is_rep"],
                               EPS_SP),
            jev.rmse_traclus(r["jtc"], eps_sp=EPS_SP))
    np.testing.assert_allclose((r_dsc, r_s2t, r_tc), want, rtol=1e-5)

