"""PyTorch port: ``run_dsc`` end to end held against ``repro.core.dsc``.

Both pipelines run the same numpy-generated batch under the slice's
kernel plan (join, TSA2 and clustering kernels: interpret-mode Pallas in
the reference, the plain versions here on the CPU) and under the default
plan.  Labels (``member_of``, ``is_rep``, ``is_outlier``) and the
segmentation must be equal.  Float outputs carry stated tolerances:

* ``vote`` sums best-match weights in PyTorch's order, not XLA's, and the
  kernel plan's weights may sit an ulp apart (XLA contracts the Pallas
  join's d2 into an FMA): 1e-5 absolute on sums of at most C weights.
* ``alpha`` / ``k`` / ``sscr`` / ``rmse`` reduce vectors of float32 in
  another order (and the similarity scatter's per-cell sums may differ by
  an ulp): 1e-5 relative.
"""
import numpy as np
import pytest
import torch

from repro.core import dsc as jdsc
from repro.core.evaluation import cluster_purity, leg_labels, pairwise_f1
from repro.core.types import DSCParams as JParams
from repro.data import synthetic as jsyn
from repro_torch.core import dsc as tdsc
from repro_torch.core.plan import EnginePlan, resolve_plan
from repro_torch.core.types import DSCParams, TrajectoryBatch
from repro_torch.data import synthetic as tsyn

torch.set_num_threads(1)

FIELDS = ("x", "y", "t", "valid", "traj_id")
KERNEL_PLAN = dict(use_kernel=True, seg_use_kernel=True,
                   cluster_use_kernel=True)
PLANS = {"default": {}, "kernels": KERNEL_PLAN}
FIG1 = dict(eps_sp=0.42, eps_t=1.0, delta_t=0.0, w=6, tau=0.15,
            alpha_sigma=-1.0, k_sigma=-1.0)


def _port(jb):
    return TrajectoryBatch.from_arrays(
        *(np.asarray(getattr(jb, f)) for f in FIELDS), device="cpu")


def _ais_params(jb):
    diam, mean_dt = jsyn.default_dsc_params_for(jb)
    return dict(eps_sp=0.15 * diam, eps_t=mean_dt, delta_t=0.0, w=12,
                tau=0.4, alpha_sigma=-1.0, k_sigma=-1.0,
                segmentation="tsa2")


def _scenario(name):
    if name == "fig1_tsa2":
        return jsyn.figure1_scenario(n_per_route=4, points_per_leg=24,
                                     seed=0)[0], dict(FIG1, segmentation="tsa2")
    if name == "fig1_tsa1":
        return jsyn.figure1_scenario(n_per_route=4, points_per_leg=24,
                                     seed=0)[0], dict(FIG1, segmentation="tsa1")
    if name == "crossing":
        return jsyn.crossing_scenario()[0], dict(FIG1, segmentation="tsa2",
                                                 delta_t=3.0)
    jb = jsyn.ais_like(n_vessels=24, max_points=96, seed=1)[0]
    return jb, _ais_params(jb)


def _compare(jo, to):
    for f in ("member_of", "is_rep", "is_outlier"):
        assert np.array_equal(np.asarray(getattr(jo.result, f)),
                              getattr(to.result, f).numpy()), f
    for f in ("cut", "sub_local", "num_subs"):
        assert np.array_equal(np.asarray(getattr(jo.seg, f)),
                              getattr(to.seg, f).numpy()), f
    for f in ("card", "valid"):
        assert np.array_equal(np.asarray(getattr(jo.table, f)),
                              getattr(to.table, f).numpy()), f
    np.testing.assert_allclose(to.vote.numpy(), np.asarray(jo.vote),
                               rtol=0, atol=1e-5)
    for a, b in ((to.result.alpha_used, jo.result.alpha_used),
                 (to.result.k_used, jo.result.k_used),
                 (to.sscr, jo.sscr), (to.rmse, jo.rmse)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    assert to.sim.shape == np.asarray(jo.sim).shape


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("scenario", ["fig1_tsa2", "fig1_tsa1", "crossing",
                                      "ais"])
def test_run_dsc_matches_reference(scenario, plan):
    jb, kw = _scenario(scenario)
    jo = jdsc.run_dsc(jb, JParams(**kw), **PLANS[plan])
    to = tdsc.run_dsc(_port(jb), DSCParams(**kw), device="cpu",
                      plan=EnginePlan(**PLANS[plan]))
    _compare(jo, to)
    assert to.rounds >= 1
    assert int(to.result.is_rep.sum()) >= 1


def test_plan_object_equals_flags_and_sequential_engine(fig1):
    """The kernel plan, the default plan (``plan=None``) and the
    sequential engine give the same labels; a bad engine name raises."""
    jb, _ = fig1
    p = DSCParams(**FIG1, segmentation="tsa2")
    tb = _port(jb)
    a = tdsc.run_dsc(tb, p, device="cpu", plan=EnginePlan(**KERNEL_PLAN))
    b = tdsc.run_dsc(tb, p, device="cpu")
    c = tdsc.run_dsc(tb, p, device="cpu",
                     plan=EnginePlan(cluster_engine="sequential"))
    for f in ("member_of", "is_rep", "is_outlier", "member_sim"):
        assert torch.equal(getattr(a.result, f), getattr(b.result, f))
        assert torch.equal(getattr(a.result, f), getattr(c.result, f))
    assert c.rounds is None
    assert resolve_plan(None) == EnginePlan()
    for bad, msg in ((dict(mode="stream"), "unknown mode"),
                     (dict(cluster_engine="greedy"), "unknown cluster engine"),
                     (dict(sim_mode="sparse"), "unknown sim_mode")):
        with pytest.raises(ValueError, match=msg):
            tdsc.run_dsc(tb, p, device="cpu", plan=EnginePlan(**bad))


@pytest.mark.parametrize("kw,item", [
    (dict(sim_mode="topk", use_index=True), "item 8"),
    (dict(use_index=True), "item 8")])
def test_later_slices_raise(kw, item):
    tb, _ = tsyn.figure1_scenario(n_per_route=1, points_per_leg=8,
                                  device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        tdsc.run_dsc(tb, DSCParams(), device="cpu", plan=EnginePlan(**kw))


def test_stage_times_and_summary(fig1):
    jb, _ = fig1
    times = {}
    out = tdsc.run_dsc(_port(jb), DSCParams(**FIG1, segmentation="tsa2"),
                       device="cpu", stage_times=times)
    assert list(times) == list(tdsc.STAGES)
    assert all(v >= 0.0 for v in times.values())
    s = tdsc.cluster_summary(out)
    jo = jdsc.run_dsc(jb, JParams(**FIG1, segmentation="tsa2"))
    js = jdsc.cluster_summary(jo)
    assert s["clusters"] == js["clusters"] and s["outliers"] == js["outliers"]


def test_groundtruth_recovery(fig1):
    """Port of ``tests/test_system.py::test_groundtruth_recovery``: near-
    perfect purity of the port's clusters w.r.t. the leg ground truth."""
    jb, route = fig1
    params = DSCParams(**FIG1, segmentation="tsa2")
    out = tdsc.run_dsc(_port(jb), params, device="cpu",
                       plan=EnginePlan(**KERNEL_PLAN))
    member_of = out.result.member_of.numpy()
    is_rep = out.result.is_rep.numpy()
    valid = out.table.valid.numpy()
    assign = {int(s): int(s) if is_rep[s] else int(member_of[s])
              for s in np.nonzero(valid)[0]
              if is_rep[s] or member_of[s] >= 0}
    assert assign
    origins, dests = jsyn.route_origins_dests(route)
    t = np.asarray(jb.t)
    t_split = float(t[np.asarray(jb.valid)].max()) / 2
    truth = leg_labels(jb, out.seg.sub_local.numpy(), origins, dests,
                       t_split, params.max_subtrajs_per_traj)
    assert cluster_purity(assign, truth) >= 0.95
    assert pairwise_f1(assign, truth) >= 0.5
    assert float(out.sscr) > 0.0 and float(out.rmse) <= params.eps_sp
