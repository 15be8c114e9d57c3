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
import contextlib
import dataclasses

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


@pytest.mark.parametrize("mode", ["materialize", "fused"])
@pytest.mark.parametrize("scenario", ["fig1_tsa2", "ais"])
def test_join_field(scenario, mode):
    """``DSCOutput.join``: the cube in materialize mode, equal to the
    reference's; None in fused mode.  Indices are equal; weights agree to
    2.4e-7: under ``jit`` XLA's CPU compiler contracts the reference's
    ``dx*dx + dy*dy`` into an FMA, so single weights sit one ulp of 1.0
    apart (measured: 120 of 27,648 on fig1, 160 of 55,296 on ais, each
    1.19e-7), as in ``tests/test_torch_join.py``."""
    jb, kw = _scenario(scenario)
    jo = jdsc.run_dsc(jb, JParams(**kw), mode=mode)
    to = tdsc.run_dsc(_port(jb), DSCParams(**kw), device="cpu",
                      plan=EnginePlan(mode=mode))
    _compare(jo, to)
    if mode == "fused":
        assert jo.join is None and to.join is None
        return
    assert np.array_equal(np.asarray(jo.join.best_idx),
                          to.join.best_idx.numpy())
    np.testing.assert_allclose(to.join.best_w.numpy(),
                               np.asarray(jo.join.best_w), rtol=0,
                               atol=2.4e-7)
    assert bool((to.join.best_idx >= 0).any())


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


@pytest.mark.parametrize("sim_mode", ["topk", "dense"])
def test_use_index_matches_reference(sim_mode):
    """Materialize mode under the default plan with ``use_index=True``
    (the plain join under the row-level prune mask): labels and
    segmentation equal to the reference's and to the unpruned run."""
    jb, kw = _scenario("ais")
    jo = jdsc.run_dsc(jb, JParams(**kw), use_index=True, sim_mode=sim_mode)
    tb, p = _port(jb), DSCParams(**kw)
    to = tdsc.run_dsc(tb, p, device="cpu",
                      plan=EnginePlan(use_index=True, sim_mode=sim_mode))
    base = tdsc.run_dsc(tb, p, device="cpu",
                        plan=EnginePlan(sim_mode=sim_mode))
    for f in ("member_of", "is_rep", "is_outlier"):
        assert np.array_equal(np.asarray(getattr(jo.result, f)),
                              getattr(to.result, f).numpy()), f
        assert torch.equal(getattr(to.result, f), getattr(base.result, f))
    for f in ("cut", "sub_local", "num_subs"):
        assert np.array_equal(np.asarray(getattr(jo.seg, f)),
                              getattr(to.seg, f).numpy()), f
    assert torch.equal(to.vote, base.vote)
    if sim_mode == "topk":
        assert to.sim_topk.k == jo.sim_topk.k
        assert int(to.sim_overflow) == int(jo.sim_overflow) == 0
    else:
        assert torch.equal(to.sim, base.sim)


def test_stage_times_and_summary(fig1):
    jb, _ = fig1
    times = {}
    out = tdsc.run_dsc(_port(jb), DSCParams(**FIG1, segmentation="tsa2"),
                       device="cpu", stage_times=times)
    assert [k for k in times if "." not in k] == list(tdsc.STAGES)
    assert all(v >= 0.0 for v in times.values())
    s = tdsc.cluster_summary(out)
    jo = jdsc.run_dsc(jb, JParams(**FIG1, segmentation="tsa2"))
    js = jdsc.cluster_summary(jo)
    assert s["clusters"] == js["clusters"] and s["outliers"] == js["outliers"]


# the parts each plan runs inside its stages (``<stage>.<part>``)
PLAN_PARTS = {
    "dense": ["segment.table", "similarity.finalize", "cluster.thresholds",
              "cluster.round_loop"],
    "topk": ["segment.table", "cluster.thresholds", "cluster.round_loop"],
    "sequential": ["segment.table", "similarity.finalize"],
}
SPAN_PLANS = {"dense": EnginePlan(),
              "topk": EnginePlan(sim_mode="topk", sim_topk=2),
              "sequential": EnginePlan(cluster_engine="sequential")}


@pytest.mark.parametrize("plan", list(SPAN_PLANS))
def test_stage_parts(fig1, plan):
    """``stage_times`` holds the stages in order and, under dotted names,
    exactly the parts that the plan runs, each inside its stage."""
    jb, _ = fig1
    times = {}
    tdsc.run_dsc(_port(jb), DSCParams(**FIG1, segmentation="tsa2"),
                 plan=SPAN_PLANS[plan], device="cpu", stage_times=times)
    assert [k for k in times if "." not in k] == list(tdsc.STAGES)
    parts = [k for k in times if "." in k]
    assert parts == PLAN_PARTS[plan]
    assert all(v >= 0.0 for v in times.values())
    for k in parts:
        assert times[k] <= times[k.split(".")[0]], k


def _ranges(prof):
    """``name -> [(start_us, end_us)]`` of the profile's host events."""
    out = {}
    for e in prof.events():
        out.setdefault(e.name, []).append((e.time_range.start,
                                           e.time_range.end))
    return out


@pytest.mark.parametrize("times", [{}, None], ids=["timed", "untimed"])
def test_spans_are_profiler_ranges(fig1, times):
    """Under a recording profiler every span is a range of its name,
    nested inside the caller's range, each part inside its stage's; the
    profiler alone switches them on."""
    jb, _ = fig1
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            tdsc.run_dsc(_port(jb), DSCParams(**FIG1, segmentation="tsa2"),
                         device="cpu", stage_times=times)
    rng = _ranges(prof)
    (c0, c1), = rng["caller"]
    for name in list(tdsc.STAGES) + PLAN_PARTS["dense"]:
        (s, e), = rng[name]
        assert c0 <= s <= e <= c1, name
        if "." in name:
            (p0, p1), = rng[name.split(".")[0]]
            assert p0 <= s <= e <= p1, name
    if times is not None:
        assert set(times) == set(tdsc.STAGES) | set(PLAN_PARTS["dense"])


def test_spans_off_record_nothing(fig1, monkeypatch):
    """With no dict and no profiler a run enters no range, and its timer
    keeps no mark; a timer on the card makes no CUDA event then."""
    jb, _ = fig1
    entered = []

    def counting(name, *a, **kw):
        entered.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    timers = []

    class Kept(tdsc.StageTimer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            timers.append(self)

    monkeypatch.setattr(tdsc, "StageTimer", Kept)
    tdsc.run_dsc(_port(jb), DSCParams(**FIG1, segmentation="tsa2"),
                 device="cpu")
    assert entered == [] and len(timers) == 1
    timer = timers[0]
    assert not timer.record and not timer.annotate and timer._marks == []

    def no_event(*a, **kw):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    card = tdsc.StageTimer(torch.device("cuda"), record=False)
    with card.stage("cluster"):
        with card.stage("cluster.round_loop"):
            pass
    assert card._marks == [] and card.times == {} and entered == []


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


# --------------------------------------------------------------------------
# The stage entry points and run_dsc_lowerable
# --------------------------------------------------------------------------

def _same(a, b, what="out"):
    """Bitwise equality of two outputs, field by field (dataclasses,
    tensors, ints, None)."""
    if a is None or b is None:
        assert a is None and b is None, what
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    else:
        assert a == b, what


def _chain(batch, params, plan):
    """The seven stage entry points chained as ``run_dsc`` runs its stages:
    in top-K mode the similarity, cluster and score stages again with K
    doubled while the certificate fails.  The materialize kernel plan with
    the index takes the reference's host-planned route: the pruned join,
    then ``run_stage_vote_from_join``."""
    from repro_torch.kernels.stjoin import ops as stjoin_ops
    tile_ids = None
    if plan.mode == "fused":
        tile_ids, plan = tdsc.plan_fused_tile_ids(batch, params, plan)
        join = None
        vote, masks = tdsc.run_stage_join_fused(batch, params,
                                                tile_ids=tile_ids, plan=plan)
    elif plan.use_index and plan.use_kernel:
        join = stjoin_ops.subtrajectory_join(
            batch, batch, params.eps_sp, params.eps_t, params.delta_t,
            use_index=True)
        vote, masks = tdsc.run_stage_vote_from_join(batch, params, join,
                                                    plan)
    else:
        join, vote, masks = tdsc.run_stage_join(batch, params, plan)
    seg, table = tdsc.run_stage_segment(batch, params, vote, masks, plan)
    S, k, dispatches = table.num_slots, plan.sim_topk or 32, 0
    while True:
        p = plan.replace(sim_topk=min(k, S))
        sim, topk = tdsc.run_stage_similarity(batch, params, join, seg,
                                              table, tile_ids=tile_ids,
                                              plan=p)
        result, overflow = tdsc.run_stage_cluster(
            sim if topk is None else topk, table, params, p)
        sscr_v, rmse_v = tdsc.run_stage_score(result, sim, params)
        dispatches += 1
        if overflow is None or int(overflow) == 0:
            break
        k = 2 * k
    return dict(join=join, vote=vote, seg=seg, table=table, sim=sim,
                sim_topk=topk, sim_overflow=overflow, result=result,
                sscr=sscr_v, rmse=rmse_v, dispatches=dispatches)


CHAIN_PLANS = {
    "materialize": EnginePlan(**KERNEL_PLAN),
    "fused": EnginePlan(mode="fused", **KERNEL_PLAN),
    "materialize_topk": EnginePlan(sim_mode="topk", sim_topk=2,
                                   **KERNEL_PLAN),
    "fused_topk": EnginePlan(mode="fused", sim_mode="topk", sim_topk=2,
                             **KERNEL_PLAN),
    "materialize+index": EnginePlan(use_index=True, **KERNEL_PLAN),
    "materialize_plain+index": EnginePlan(use_index=True),
    "fused_topk+index": EnginePlan(mode="fused", sim_mode="topk",
                                   use_index=True, **KERNEL_PLAN)}


@pytest.mark.parametrize("plan", sorted(CHAIN_PLANS))
@pytest.mark.parametrize("scenario", ["fig1_tsa2", "ais"])
def test_stage_chain_equals_run_dsc(scenario, plan):
    """Each stage's outputs fed into the next give ``run_dsc``'s outputs
    bit for bit, every field (the cube, the lists and the certificate
    included), with as many top-K dispatches (K = 2 widens)."""
    jb, kw = _scenario(scenario)
    tb, p, plan = _port(jb), DSCParams(**kw), CHAIN_PLANS[plan]
    out = tdsc.run_dsc(tb, p, device="cpu", plan=plan)
    got = _chain(tb, p, plan)
    assert got.pop("dispatches") == out.dispatches
    for f, v in got.items():
        _same(v, getattr(out, f), f)
    assert int(out.result.is_rep.sum()) >= 1


def test_stage_chain_widens(fig1):
    """K = 2 on fig1 does spill: the chain and ``run_dsc`` both widen."""
    jb, _ = fig1
    out = tdsc.run_dsc(_port(jb), DSCParams(**FIG1, segmentation="tsa2"),
                       device="cpu", plan=CHAIN_PLANS["fused_topk"])
    assert out.dispatches > 1 and out.sim_topk.k > 2


def test_plan_fused_tile_ids_returns_the_plan(fig1):
    """``(tiles, plan)``: no tiles without the index or in materialize
    mode; the plan comes back unchanged (the kernels take no geometry)."""
    jb, _ = fig1
    tb, p = _port(jb), DSCParams(**FIG1, segmentation="tsa2")
    for plan in (EnginePlan(), EnginePlan(mode="fused"),
                 EnginePlan(use_index=True)):
        assert tdsc.plan_fused_tile_ids(tb, p, plan) == (None, plan)
    plan = EnginePlan(mode="fused", use_index=True, fused_rows=64)
    tiles, back = tdsc.plan_fused_tile_ids(tb, p, plan)
    assert back is plan and tiles is not None


LOWERABLE = {"materialize": EnginePlan(**KERNEL_PLAN),
             "fused": EnginePlan(mode="fused", **KERNEL_PLAN),
             "default": EnginePlan(),
             "fused_topk": EnginePlan(mode="fused", sim_mode="topk")}


@pytest.mark.parametrize("plan", sorted(LOWERABLE))
@pytest.mark.parametrize("scenario", ["fig1_tsa2", "ais"])
def test_run_dsc_lowerable_equals_run_dsc(scenario, plan):
    """One dispatch, every field bitwise ``run_dsc``'s (top-K: at the
    default K, where the certificate holds, so ``run_dsc`` does not
    widen)."""
    jb, kw = _scenario(scenario)
    tb, p, plan = _port(jb), DSCParams(**kw), LOWERABLE[plan]
    low = tdsc.run_dsc_lowerable(tb, p, plan, device="cpu")
    out = tdsc.run_dsc(tb, p, device="cpu", plan=plan)
    assert low.dispatches == out.dispatches == 1
    _same(low, out)


def test_run_dsc_lowerable_returns_the_certificate(fig1):
    """No widen loop: at K = 2 the certificate fails and comes back with
    the one dispatch's result, as ``run_dsc(on_overflow="degrade")``; K
    is clamped to S."""
    jb, _ = fig1
    tb, p = _port(jb), DSCParams(**FIG1, segmentation="tsa2")
    plan = EnginePlan(mode="fused", sim_mode="topk", sim_topk=2)
    low = tdsc.run_dsc_lowerable(tb, p, plan, device="cpu")
    deg = tdsc.run_dsc(tb, p, device="cpu", plan=plan, on_overflow="degrade")
    assert low.dispatches == 1 and int(low.sim_overflow) > 0
    _same(low, deg)
    S = tb.num_trajs * p.max_subtrajs_per_traj
    wide = tdsc.run_dsc_lowerable(tb, p, plan.replace(sim_topk=10 * S),
                                  device="cpu")
    assert wide.sim_topk.k == S and int(wide.sim_overflow) == 0


def test_run_dsc_lowerable_refuses_the_index(fig1):
    jb, _ = fig1
    tb, p = _port(jb), DSCParams(**FIG1, segmentation="tsa2")
    msg = ("run_dsc_lowerable requires use_index=False (index planning is "
           "host-driven); use run_dsc")
    with pytest.raises(ValueError) as e:
        tdsc.run_dsc_lowerable(tb, p, EnginePlan(use_index=True),
                               device="cpu")
    assert str(e.value) == msg
    with pytest.raises(ValueError) as je:
        jdsc.run_dsc_lowerable(jb, JParams(**FIG1, segmentation="tsa2"),
                               jdsc.EnginePlan(use_index=True))
    assert str(je.value) == msg


# the reference's deprecated flags of run_dsc: name -> (positional args,
# keywords); each run under the port and the reference on fig1
FLAG_CASES = {
    "use_kernel": ((True,), {}),
    "use_index": ((), dict(use_index=True)),
    "mode": ((), dict(mode="fused")),
    "fused_tiles": ((), dict(mode="fused", use_index=True,
                             fused_tiles=(64, 16, 128))),
    "cluster_engine": ((), dict(cluster_engine="sequential")),
    "cluster_use_kernel": ((), dict(cluster_use_kernel=True)),
    "seg_use_kernel": ((), dict(seg_use_kernel=True)),
    "sim_mode": ((), dict(sim_mode="topk")),
    "sim_topk": ((), dict(sim_mode="topk", sim_topk=2)),
    "sim_panel": ((), dict(sim_mode="topk", sim_panel=16)),
    "on_overflow": ((), dict(sim_mode="topk", sim_topk=2,
                             on_overflow="degrade")),
}


@pytest.mark.parametrize("flag", sorted(FLAG_CASES))
def test_run_dsc_deprecated_flags(fig1, flag):
    """Each deprecated flag of the reference's ``run_dsc`` gives its
    labels and top-K certificate, and the same bits as the port's run of
    the plan the flag materializes."""
    jb, _ = fig1
    kw = dict(FIG1, segmentation="tsa2")
    args, flags = FLAG_CASES[flag]
    jo = jdsc.run_dsc(jb, JParams(**kw), *args, **flags)
    tb, p = _port(jb), DSCParams(**kw)
    to = tdsc.run_dsc(tb, p, *args, device="cpu", **flags)
    for f in ("member_of", "is_rep", "is_outlier"):
        assert np.array_equal(np.asarray(getattr(jo.result, f)),
                              getattr(to.result, f).numpy()), f
    if jo.sim_overflow is None:
        assert to.sim_overflow is None
    else:
        assert int(to.sim_overflow) == int(jo.sim_overflow)
        assert to.sim_topk.k == np.asarray(jo.sim_topk.ids).shape[1]
    legacy = dict(flags)
    overflow = legacy.pop("on_overflow", None)
    if args:
        legacy["use_kernel"] = args[0]
    plan = resolve_plan(None, **legacy)
    _same(to, tdsc.run_dsc(tb, p, plan=plan, device="cpu",
                           on_overflow=overflow))


def test_run_dsc_deprecated_flag_errors(fig1):
    """A plan mixed with a flag, and ``on_overflow`` with
    ``sim_topk_retry=False``, raise the reference's errors word for word;
    ``sim_topk_retry=False`` alone is the ``"raise"`` policy."""
    jb, _ = fig1
    kw = dict(FIG1, segmentation="tsa2")
    tb, p, jp = _port(jb), DSCParams(**kw), JParams(**kw)
    cases = (
        ((True,), dict(plan=EnginePlan()), dict(plan=jdsc.EnginePlan())),
        ((), dict(mode="fused", plan=EnginePlan()),
         dict(mode="fused", plan=jdsc.EnginePlan())),
        ((), dict(sim_mode="topk", on_overflow="widen",
                  sim_topk_retry=False), None),
        ((), dict(sim_mode="topk", sim_topk=2, sim_topk_retry=False), None),
    )
    for args, tkw, jkw in cases:
        jkw = tkw if jkw is None else jkw
        with pytest.raises((ValueError, RuntimeError)) as te:
            tdsc.run_dsc(tb, p, *args, device="cpu", **tkw)
        with pytest.raises((ValueError, RuntimeError)) as je:
            jdsc.run_dsc(jb, jp, *args, **jkw)
        assert type(te.value) is type(je.value)
        assert str(te.value) == str(je.value)
