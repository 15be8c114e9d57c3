"""PyTorch port: the resilient stage runner held against the JAX
package's (``tests/test_resilient.py``, on the port).

On fig1 and ``ais_like``, on the CPU:

* a fresh ``run_resilient`` is bitwise the port's ``run_dsc``; its labels
  equal the reference's ``run_resilient``;
* a crash at each stage, then a resume, is bitwise an uninterrupted run;
* the overflow policies (widen, degrade, raise), the corruption fallback
  and fail policies, a truncated leaf, transient retries and their
  exhaustion behave as the reference's;
* the telemetry stream names the reference's events, with equal non-time
  fields (``ts``, ``wall_s``, ``per_partition_s`` are clock readings; a
  fallback's ``error`` names its run's own directory);
* a run crashed in the reference resumes in the port (and the reverse)
  and gives the reference's labels (the stages that run in the other
  package sum votes in their own order, so floats agree to ulps there —
  ``tests/test_torch_dsc.py`` states that tolerance — and labels
  exactly).
"""
import json

import numpy as np
import pytest
import torch

from repro.core.types import DSCParams as JParams
from repro.data import synthetic as jsyn
from repro.run import FaultPlan as JFaultPlan
from repro.run import RebalancePolicy as JRebalance
from repro.run import run_resilient as jrun_resilient
from repro.run.resilient import EXIT_CODES as J_EXIT_CODES
from repro_torch.checkpoint import CheckpointManager, load_checkpoint_flat
from repro_torch.core.dsc import run_dsc
from repro_torch.core.plan import EnginePlan
from repro_torch.core.types import DSCParams, TrajectoryBatch
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.run import (EXIT_CODES, CheckpointCorruption, FaultPlan,
                             InjectedCrash, OverflowViolation,
                             RebalancePolicy, RetriesExhausted,
                             read_telemetry, run_resilient,
                             run_resilient_distributed)
from repro_torch.run.resilient import STAGES

pytestmark = pytest.mark.faults

torch.set_num_threads(1)

FIELDS = ("x", "y", "t", "valid", "traj_id")
LABELS = ("member_of", "is_rep", "is_outlier")
# telemetry fields that read a clock
CLOCK_FIELDS = ("ts", "wall_s", "per_partition_s")


def _scenario(name):
    if name == "fig1":
        jb, _ = jsyn.figure1_scenario(n_per_route=2, points_per_leg=16,
                                      seed=0)
        kw = dict(eps_sp=0.42, eps_t=1.0, delta_t=0.0, w=6, tau=0.15,
                  alpha_sigma=-1.0, k_sigma=-1.0, segmentation="tsa2")
    else:
        jb, _ = jsyn.ais_like(n_vessels=16, max_points=48, seed=1)
        diam, mean_dt = jsyn.default_dsc_params_for(jb)
        kw = dict(eps_sp=0.15 * diam, eps_t=mean_dt, delta_t=0.0, w=8,
                  tau=0.4, alpha_sigma=-1.0, k_sigma=-1.0,
                  segmentation="tsa1")
    tb = TrajectoryBatch.from_arrays(
        *(np.asarray(getattr(jb, f)) for f in FIELDS), device="cpu")
    return jb, JParams(**kw), tb, DSCParams(**kw)


@pytest.fixture(scope="module", params=["fig1", "ais"])
def case(request):
    jb, jp, tb, tp = _scenario(request.param)
    return dict(name=request.param, jb=jb, jp=jp, tb=tb, tp=tp,
                want=run_dsc(tb, tp, device="cpu"))


@pytest.fixture(scope="module")
def fig1():
    jb, jp, tb, tp = _scenario("fig1")
    return dict(jb=jb, jp=jp, tb=tb, tp=tp, want=run_dsc(tb, tp,
                                                         device="cpu"))


def run(c, **kw):
    return run_resilient(c["tb"], c["tp"], device="cpu", **kw)


def assert_bitwise(out, want):
    for f in (*LABELS, "member_sim", "alpha_used", "k_used"):
        assert torch.equal(getattr(out.result, f),
                           getattr(want.result, f)), f
    assert torch.equal(out.sscr, want.sscr)
    assert torch.equal(out.rmse, want.rmse)
    assert torch.equal(out.vote, want.vote)
    for f in ("cut", "sub_local", "num_subs", "score"):
        assert torch.equal(getattr(out.seg, f), getattr(want.seg, f)), f


def assert_labels(out, jout):
    for f in LABELS:
        assert np.array_equal(getattr(out.result, f).numpy(),
                              np.asarray(getattr(jout.result, f))), f


def test_fresh_run_matches_run_dsc(case):
    res = run(case)
    assert res.resumed_from == 0 and res.widen_count == 0
    assert res.fallback_steps == [] and res.rebalance_count == 0
    assert_bitwise(res.output, case["want"])
    assert res.sscr == float(case["want"].sscr)


def test_fresh_run_labels_match_reference(case):
    jres = jrun_resilient(case["jb"], case["jp"])
    assert_labels(run(case).output, jres.output)


def test_checkpointed_run_writes_every_stage(fig1, tmp_path):
    res = run(fig1, checkpoint_dir=tmp_path / "ck")
    assert_bitwise(res.output, fig1["want"])
    assert CheckpointManager(tmp_path / "ck").available_steps() == [1, 2, 3,
                                                                    4, 5]
    events = read_telemetry(tmp_path / "ck" / "telemetry.jsonl")
    assert [e["event"] for e in events] == [e["event"] for e in res.events]
    assert sum(e["event"] == "stage_done" for e in events) == len(STAGES)


@pytest.mark.parametrize("stage", STAGES)
def test_resume_after_crash_is_bitwise(case, stage, tmp_path):
    root = tmp_path / "ck"
    with pytest.raises(InjectedCrash):
        run(case, checkpoint_dir=root, fault_plan=FaultPlan(crash_at=stage))
    res = run(case, checkpoint_dir=root)
    assert res.resumed_from == STAGES.index(stage)
    assert_bitwise(res.output, case["want"])


@pytest.mark.parametrize("mode", ["materialize", "fused"])
def test_resume_after_crash_topk_plans(fig1, mode, tmp_path):
    """The fused and materialize top-K plans with widening: a crash at the
    cluster stage resumes to the uninterrupted run's output."""
    plan = EnginePlan(mode=mode, sim_mode="topk", sim_topk=2)
    want = run(fig1, plan=plan)
    assert want.widen_count >= 1
    root = tmp_path / "ck"
    with pytest.raises(InjectedCrash):
        run(fig1, plan=plan, checkpoint_dir=root,
            fault_plan=FaultPlan(crash_at="cluster"))
    res = run(fig1, plan=plan, checkpoint_dir=root)
    assert res.resumed_from == 3
    assert res.widen_count == want.widen_count
    assert_bitwise(res.output, want.output)
    for f in ("ids", "sims", "spill", "degree", "row_sum", "row_sumsq"):
        assert torch.equal(getattr(res.output.sim_topk, f),
                           getattr(want.output.sim_topk, f)), f


def test_overflow_widen_recovers_dense_labels(case):
    res = run(case, sim_mode="topk", sim_topk=2, on_overflow="widen")
    jres = jrun_resilient(case["jb"], case["jp"], sim_mode="topk",
                          sim_topk=2, on_overflow="widen")
    assert res.widen_count == jres.widen_count >= 1
    for f in LABELS:
        assert torch.equal(getattr(res.output.result, f),
                           getattr(case["want"].result, f)), f
    assert int(res.output.sim_overflow) == 0
    assert res.output.sim_topk.k == int(jres.output.sim_topk.ids.shape[1])


def test_overflow_degrade_records_certificate(fig1):
    res = run(fig1, sim_mode="topk", sim_topk=2, on_overflow="degrade")
    assert res.widen_count == 0 and int(res.output.sim_overflow) > 0
    assert any(e["event"] == "overflow_degraded" for e in res.events)


def test_overflow_raise(fig1):
    with pytest.raises(OverflowViolation, match="sim_topk"):
        run(fig1, sim_mode="topk", sim_topk=2, on_overflow="raise")


def test_overflow_widen_applies_to_restored_state(fig1, tmp_path):
    root = tmp_path / "ck"
    res0 = run(fig1, checkpoint_dir=root, sim_mode="topk", sim_topk=2,
               on_overflow="degrade")
    assert int(res0.output.sim_overflow) > 0
    res = run(fig1, checkpoint_dir=root, sim_mode="topk", sim_topk=2,
              on_overflow="widen")
    assert res.widen_count >= 1 and int(res.output.sim_overflow) == 0
    for f in LABELS:
        assert torch.equal(getattr(res.output.result, f),
                           getattr(fig1["want"].result, f)), f


def test_bad_policies_and_plans(fig1):
    with pytest.raises(ValueError, match="on_overflow"):
        run(fig1, on_overflow="explode")
    with pytest.raises(ValueError, match="on_corruption"):
        run(fig1, on_corruption="shrug")
    with pytest.raises(ValueError, match="partition"):
        run(fig1, fault_plan=FaultPlan(slow=(("join", 3, 1.0),)))
    with pytest.raises(ValueError, match="mode"):
        run(fig1, rebalance=RebalancePolicy(mode="bogus"))
    with pytest.raises(ValueError, match="both plan= and legacy"):
        run(fig1, plan=EnginePlan(), sim_mode="topk")
    # the distributed runner checks its policies before it spawns a rank
    from repro_torch.core.partitioning import partition_batch
    from repro_torch.distributed.mesh import Mesh
    parts = partition_batch(fig1["tb"], 2)
    mesh = Mesh((2, 1), "gloo", "cpu")
    with pytest.raises(ValueError, match="on_overflow"):
        run_resilient_distributed(parts, fig1["tp"], mesh,
                                  on_overflow="explode")
    with pytest.raises(ValueError, match="both plan= and legacy"):
        run_resilient_distributed(parts, fig1["tp"], mesh, plan=EnginePlan(),
                                  sim_mode="topk")


def test_transient_retry_schedule(fig1):
    delays = []
    res = run(fig1, fault_plan=FaultPlan(transient_at="segment",
                                         transient_count=2),
              max_retries=3, sleep=delays.append)
    assert delays == [0.5, 1.0]
    retries = [e for e in res.events if e["event"] == "retry"]
    assert [e["attempt"] for e in retries] == [1, 2]
    assert all(e["stage"] == "segment" for e in retries)
    assert_bitwise(res.output, fig1["want"])


def test_transient_retries_exhausted(fig1):
    with pytest.raises(RetriesExhausted):
        run(fig1, fault_plan=FaultPlan(transient_at="similarity",
                                       transient_count=9),
            max_retries=2, sleep=lambda s: None)


def test_corrupted_checkpoint_falls_back_a_step(fig1, tmp_path):
    root = tmp_path / "ck"
    with pytest.raises(InjectedCrash):
        run(fig1, checkpoint_dir=root,
            fault_plan=FaultPlan(corrupt_stage="similarity",
                                 crash_at="cluster"))
    res = run(fig1, checkpoint_dir=root)
    assert res.fallback_steps == [3] and res.resumed_from == 2
    assert any(e["event"] == "checkpoint_fallback" for e in res.events)
    assert_bitwise(res.output, fig1["want"])


def test_corruption_fail_policy(fig1, tmp_path):
    root = tmp_path / "ck"
    with pytest.raises(InjectedCrash):
        run(fig1, checkpoint_dir=root,
            fault_plan=FaultPlan(corrupt_stage="segment",
                                 crash_at="similarity"))
    with pytest.raises(CheckpointCorruption):
        run(fig1, checkpoint_dir=root, on_corruption="fail")


def test_truncated_leaf_falls_back(fig1, tmp_path):
    import os
    root = tmp_path / "ck"
    run(fig1, checkpoint_dir=root)
    mgr = CheckpointManager(root)
    last = mgr.available_steps()[-1]
    leaf = sorted(mgr.step_dir(last).glob("leaf_*.npy"))[0]
    os.truncate(leaf, max(1, leaf.stat().st_size // 2))
    with pytest.raises((IOError, EOFError, ValueError)):
        load_checkpoint_flat(root, step=last)
    res = run(fig1, checkpoint_dir=root)
    assert res.fallback_steps == [last] and res.resumed_from == last - 1
    assert_bitwise(res.output, fig1["want"])


@pytest.mark.parametrize("sync", [False, True])
def test_sync_and_async_saves_same_resume(fig1, sync, tmp_path):
    root = tmp_path / "ck"
    with pytest.raises(InjectedCrash):
        run(fig1, checkpoint_dir=root, sync_saves=sync,
            fault_plan=FaultPlan(crash_at="cluster"))
    assert CheckpointManager(root).available_steps() == [1, 2, 3]
    res = run(fig1, checkpoint_dir=root, sync_saves=sync)
    assert res.resumed_from == 3
    assert_bitwise(res.output, fig1["want"])


def _events(events):
    """Telemetry with the clock readings (and a fallback's directory
    specific error text) taken out."""
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in CLOCK_FIELDS}
        if e["event"] == "checkpoint_fallback":
            e.pop("error")
        out.append(e)
    return out


PLANS = {
    "crash": dict(crash_at="similarity"),
    "transient": dict(transient_at="cluster", transient_count=2),
    "corrupt": dict(corrupt_stage="segment", crash_at="cluster"),
    "slow": dict(slow=(("join", 0, 5.0), ("refine", 0, 1.0))),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_telemetry_matches_reference(fig1, name, tmp_path):
    """The same fault plan (then a resume, where it crashes) writes the
    reference's event stream, field for field but the clock."""
    streams = {}
    for pkg, runner, plan_cls in (
            ("port", lambda **kw: run(fig1, **kw), FaultPlan),
            ("reference", lambda **kw: jrun_resilient(fig1["jb"],
                                                      fig1["jp"], **kw),
             JFaultPlan)):
        root = tmp_path / pkg
        kw = dict(checkpoint_dir=root, sleep=lambda s: None,
                  sim_mode="topk", sim_topk=4)
        try:
            runner(fault_plan=plan_cls(**PLANS[name]), **kw)
        except Exception as e:  # noqa: BLE001 - the scripted crash
            assert type(e).__name__ == "InjectedCrash"
            runner(**kw)
        streams[pkg] = _events(read_telemetry(root / "telemetry.jsonl"))
    assert streams["port"] == streams["reference"]


def test_telemetry_torn_tail_and_damage(tmp_path):
    p = tmp_path / "telemetry.jsonl"
    p.write_text(json.dumps({"schema": 1, "event": "a"}) + "\n"
                 + '{"schema": 1, "event": "c", "tru')
    assert [e["event"] for e in read_telemetry(p)] == ["a"]
    p.write_text('{"event": "a"}\ngarbage\n{"event": "b"}\n')
    with pytest.raises(ValueError, match="line 2"):
        read_telemetry(p)


@pytest.mark.parametrize("crashed_in", ["reference", "port"])
def test_resume_across_packages(case, crashed_in, tmp_path):
    """Crash at the cluster stage in one package, resume in the other:
    the reference's labels, and the port resumes from the third stage."""
    root = tmp_path / "ck"
    if crashed_in == "reference":
        with pytest.raises(Exception, match="injected crash"):
            jrun_resilient(case["jb"], case["jp"], checkpoint_dir=root,
                           fault_plan=JFaultPlan(crash_at="cluster"))
        res = run(case, checkpoint_dir=root)
        assert res.resumed_from == 3
        out = res.output
    else:
        with pytest.raises(InjectedCrash):
            run(case, checkpoint_dir=root,
                fault_plan=FaultPlan(crash_at="cluster"))
        jres = jrun_resilient(case["jb"], case["jp"], checkpoint_dir=root)
        assert jres.resumed_from == 3
        out = jres.output
    want = jrun_resilient(case["jb"], case["jp"]).output
    for f in LABELS:
        assert np.array_equal(np.asarray(getattr(out.result, f)),
                              np.asarray(getattr(want.result, f))), f


def test_checkpoint_leaves_match_reference(fig1, tmp_path):
    """Every stage writes the reference's leaf paths, shapes and dtypes
    (the packed TSA2 words as uint32)."""
    run(fig1, checkpoint_dir=tmp_path / "t")
    jrun_resilient(fig1["jb"], fig1["jp"], checkpoint_dir=tmp_path / "j")
    for step in range(1, len(STAGES) + 1):
        t, _ = load_checkpoint_flat(tmp_path / "t", step)
        j, _ = load_checkpoint_flat(tmp_path / "j", step)
        assert list(t) == list(j), step
        for k in t:
            assert (t[k].dtype, t[k].shape) == (j[k].dtype, j[k].shape), k


def test_policies_and_plans_match_reference(tmp_path):
    fp = FaultPlan(crash_at="cluster", transient_at="join",
                   transient_count=2, corrupt_stage="segment",
                   corrupt_leaf=3, slow=(("join", 1, 2.5),),
                   stream_poison=((1, 4),), crash_at_advance=7)
    assert fp.to_json() == JFaultPlan.from_json(fp.to_json()).to_json()
    assert FaultPlan.from_json(fp.to_json()) == fp
    pol = RebalancePolicy(mode="apply", consecutive=2, max_applies=3)
    assert pol.to_json() == JRebalance.from_json(pol.to_json()).to_json()
    with pytest.raises(ValueError, match="unknown FaultPlan fields"):
        FaultPlan.from_dict({"crash_on": "join"})
    assert EXIT_CODES == J_EXIT_CODES


def test_straggler_copy_matches_reference():
    from repro.distributed.straggler import StragglerMonitor as JMon
    mon, jmon = StragglerMonitor(n_hosts=4, window=4), JMon(4, window=4)
    for _ in range(4):
        mon.record_all([1.0, 1.0, 1.0, 5.0])
        jmon.record_all([1.0, 1.0, 1.0, 5.0])
    assert mon.check() == jmon.check() and 3 in mon.flagged
    assert mon.change_detected(3) == jmon.change_detected(3)
    for _ in range(4):
        mon.record_all([1.0, 1.0, 1.0, 9.0])
        jmon.record_all([1.0, 1.0, 1.0, 9.0])
    assert mon.check() == jmon.check()
    assert mon.change_detected(3) and jmon.change_detected(3)
    from repro.distributed.straggler import suggest_rebalance_edges as jsug
    from repro_torch.distributed.straggler import suggest_rebalance_edges
    rng = np.random.default_rng(7)
    times = np.round(rng.uniform(0, 50, 400), 1)      # with ties
    part_of = np.minimum((times // 12.5).astype(int), 3)
    for flagged, P in (({3: 9.0}, 4), ({1: 1.5, 2: 4.0}, 4), ({}, 3),
                       ({0: 0.5}, 5), ({2: 31.0}, 2)):
        got = suggest_rebalance_edges(times, part_of, flagged, P)
        want = jsug(times, part_of, flagged, P)
        assert got.dtype == want.dtype == np.float64
        assert np.array_equal(got, want), (flagged, P)


def test_rebalance_policy_round_trip(tmp_path):
    """``RebalancePolicy`` through JSON and files, strict, in both
    packages and across them."""
    pol = RebalancePolicy(mode="apply", consecutive=2, max_applies=3)
    assert RebalancePolicy.from_json(pol.to_json()) == pol
    assert pol.replace(mode="off") == RebalancePolicy(
        mode="off", consecutive=2, max_applies=3)
    pol.save(tmp_path / "t.json")
    JRebalance(mode="suggest", max_applies=0).save(tmp_path / "j.json")
    assert JRebalance.load(tmp_path / "t.json").to_dict() == pol.to_dict()
    assert RebalancePolicy.load(tmp_path / "j.json") == RebalancePolicy(
        mode="suggest", max_applies=0)
    for cls in (RebalancePolicy, JRebalance):
        with pytest.raises(ValueError) as e:
            cls.from_dict({"mode": "apply", "every": 2})
        assert str(e.value) == (
            "unknown RebalancePolicy fields ['every']; known fields: "
            "['consecutive', 'max_applies', 'mode']")
        with pytest.raises(ValueError, match="consecutive"):
            cls.from_dict({"consecutive": 0})
        with pytest.raises(ValueError, match="mode"):
            cls(mode="apply").replace(mode="now")
