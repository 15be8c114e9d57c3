"""PyTorch port: the multi-device resilient runner and elastic resume
(``repro_torch.run.resilient.run_resilient_distributed``) held against the
JAX package's (``tests/test_resilient_dist.py`` and
``tests/test_elastic.py``, cut to fig1 on meshes of at most four ranks).

The reference runs once, in one subprocess with
``--xla_force_host_platform_device_count=4``, and writes its arrays to an
``.npz`` and its results and telemetry to a JSON report.  Meanwhile the
port runs the same cases on gloo CPU ranks, one ``spawn`` per mesh shape,
(4, 1), (2, 2), (2, 1) and (1, 1) in that order, each rank calling the
runner itself with one thread.  Checkpoint directories carry state from
one spawn to the next (the P = 4 crashes resume at P = 2 and P = 1).
P = 8, which the reference's tests use, is left out to keep tier-1 lean.

Every run reads the clock ``StepClock`` (one second a call), in both
packages: every stage wall is 1.0 on every rank, so straggler flags,
ratios and suggested edges are exact, and telemetry compares event for
event (``ts``, ``wall_s`` and ``per_partition_s`` still excluded, and a
fallback's ``error``, which names its run's own directory).

What must agree, and how closely:

* within the port, bitwise: a fresh staged run and the monolith
  (``run_dsc_distributed``); a crash at each stage and its resume and the
  straight run; an elastic resume and a straight run at the new P; an
  applied rebalance and a straight run at its cut; a ring-plan resume and
  its barrier twin; every rank's output;
* against the reference: labels, ``active``, the top-K certificate,
  ``resumed_from``, ``widen_count``, ``rebalance_count``,
  ``fallback_steps``, the suggested and applied edges, the error texts
  and the telemetry, equal; ``vote`` 1e-5 absolute, ``member_sim`` and
  ``sim_diag[:, :3]`` 1e-5 relative (``tests/test_torch_distributed.py``
  states why);
* a P = 4 checkpoint written by either package resumes in the other with
  the writer's straight-run labels, and both write the same leaves
  (names, shapes, dtypes).
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.faults

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STAGES = ("join", "segment", "similarity", "cluster", "refine")
LABELS = ("member_of", "is_rep", "is_outlier")
TABLE_EQ = ("t_start", "t_end", "card", "valid", "traj_row")
FIG1 = dict(eps_sp=0.42, eps_t=1.0, delta_t=0.0, w=6, tau=0.15,
            alpha_sigma=-1.0, k_sigma=-1.0, segmentation="tsa2")
CLOCK_FIELDS = ("ts", "wall_s", "per_partition_s")
TOPK4 = dict(sim_mode="topk", sim_topk=4)
RING = dict(sim_mode="topk", sim_topk=48, halo_stream="ring",
            sim_exchange="ring")
MARK_WAIT_S = 300


class StepClock:
    """A clock that advances one second a call."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


# the reference's side: the cases of both packages, by name, as the
# reference runs them (the port's ranks run the same names below)
_REFERENCE_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, shutil, sys, time
    import numpy as np
    import jax
    from repro.core.partitioning import partition_batch, repartition_batch
    from repro.core.types import DSCParams, TrajectoryBatch
    from repro.run import (FaultPlan, InjectedCrash, RebalancePolicy,
                           read_telemetry, run_resilient_distributed)
    from repro.run.resilient import STAGES

    class StepClock:
        def __init__(self):
            self.t = 0.0
        def __call__(self):
            self.t += 1.0
            return self.t

    tmp, data = sys.argv[1], np.load(sys.argv[2])
    params = DSCParams(**json.loads(sys.argv[3]))
    batch = TrajectoryBatch(*(data[f] for f in
                              ("x", "y", "t", "valid", "traj_id")))
    out, rep = {}, {}

    def mesh(P, M=1):
        return jax.make_mesh((P, M), ("part", "model"))

    def keep(name, res):
        o = res.output
        for f in ("member_of", "member_sim", "is_rep", "is_outlier"):
            out[f"{name}/{f}"] = np.asarray(getattr(o.result, f))
        for f in ("t_start", "t_end", "voting", "card", "valid",
                  "traj_row"):
            out[f"{name}/table.{f}"] = np.asarray(getattr(o.table, f))
        for f in ("vote", "active", "sim_diag"):
            out[f"{name}/{f}"] = np.asarray(getattr(o, f))
        rep[name] = dict(resumed_from=res.resumed_from,
                         widen_count=res.widen_count,
                         rebalance_count=res.rebalance_count,
                         fallback_steps=res.fallback_steps,
                         events=res.events)

    def run(name, P, M=1, parts=None, **kw):
        parts = partition_batch(batch, P) if parts is None else parts
        try:
            res = run_resilient_distributed(parts, params, mesh(P, M),
                                            clock=StepClock(), **kw)
        except (InjectedCrash, ValueError, RuntimeError) as e:
            rep[name] = dict(error=type(e).__name__ + ": " + str(e))
            return None
        keep(name, res)
        return res

    def tel(name, root):
        rep[name + "/telemetry"] = read_telemetry(root + "/telemetry.jsonl")

    # a P = 4 checkpoint for the port to resume (crash at cluster)
    run("ref_write", 4, checkpoint_dir=f"{tmp}/ref_ckpt",
        fault_plan=FaultPlan(crash_at="cluster"))
    open(f"{tmp}/ref_ckpt.done", "w").close()
    run("p4_fresh", 4)
    run("p2_fresh", 2)
    run("p1_fresh", 1)
    run("fresh22", 2, 2)
    root = f"{tmp}/ref_crash22"
    run("crash22", 2, 2, checkpoint_dir=root,
        fault_plan=FaultPlan(crash_at="cluster"))
    run("resume22", 2, 2, checkpoint_dir=root)
    tel("resume22", root)
    run("widen22", 2, 2, on_overflow="widen", **TOPK4)
    run("degrade22", 2, 2, on_overflow="degrade", **TOPK4)
    run("raise21", 2, 1, on_overflow="raise", **TOPK4)
    delays = []
    run("transient22", 2, 2, sleep=delays.append,
        fault_plan=FaultPlan(transient_at="segment", transient_count=2))
    rep["transient22"]["delays"] = delays
    root = f"{tmp}/ref_corrupt22"
    run("corrupt_crash22", 2, 2, checkpoint_dir=root,
        fault_plan=FaultPlan(corrupt_stage="segment", crash_at="similarity"))
    run("corrupt22", 2, 2, checkpoint_dir=root)
    tel("corrupt22", root)
    run("slow41", 4, fault_plan=FaultPlan(slow=SLOW_P2))
    run("off41", 4, fault_plan=FaultPlan(slow=SLOW_JOIN_P1),
        rebalance=RebalancePolicy(mode="off"))
    for stage in STAGES:
        src = f"{tmp}/ref_el_{stage}"
        run(f"el_crash_{stage}", 4, checkpoint_dir=src,
            fault_plan=FaultPlan(crash_at=stage))
        for newP in (2, 1):
            root = f"{src}_{newP}"
            shutil.copytree(src, root)
            if stage == "cluster" and newP == 2:
                run("noflag", 2, checkpoint_dir=root)
            run(f"el_{stage}_{newP}", newP, checkpoint_dir=root,
                elastic_resume=True)
            tel(f"el_{stage}_{newP}", root)
    parts4 = partition_batch(batch, 4)
    root = f"{tmp}/ref_rb"
    res = run("rb41", 4, parts=parts4, checkpoint_dir=root,
              fault_plan=FaultPlan(slow=SLOW_JOIN_P1),
              rebalance=RebalancePolicy(mode="apply"))
    tel("rb41", root)
    edges = [e for e in res.events if e["event"] == "rebalanced"][0]["edges"]
    run("rb41_oracle", 4,
        parts=repartition_batch(parts4, np.asarray(edges, np.float64)))
    root = f"{tmp}/ref_rb2"
    run("rb41_crash", 4, checkpoint_dir=root,
        fault_plan=FaultPlan(slow=SLOW_JOIN_P1, crash_at="cluster"),
        rebalance=RebalancePolicy(mode="apply"))
    run("rb41_adopt", 4, checkpoint_dir=root)
    tel("rb41_adopt", root)
    root = f"{tmp}/ref_ring"
    run("ring41_crash", 4, checkpoint_dir=root,
        fault_plan=FaultPlan(crash_at="similarity"), **RING)
    run("ring21", 2, checkpoint_dir=root, elastic_resume=True, **RING)
    tel("ring21", root)
    run("ring21_barrier", 2, sim_mode="topk", sim_topk=48)
    # the port's P = 4 checkpoint, resumed here
    t0 = time.time()
    while not os.path.exists(f"{tmp}/port_ckpt.done"):
        if time.time() - t0 > MARK_WAIT_S:
            raise SystemExit("the port's checkpoint never landed")
        time.sleep(0.2)
    run("port_resume", 4, checkpoint_dir=f"{tmp}/port_ckpt")
    np.savez(sys.argv[4], **out)
    json.dump(rep, open(sys.argv[5], "w"))
""").replace("SLOW_P2", repr(tuple((s, 2, 30.0) for s in STAGES))).replace(
    "SLOW_JOIN_P1", repr((("join", 1, 30.0),))).replace(
    "TOPK4", repr(TOPK4)).replace("RING", repr(RING)).replace(
    "MARK_WAIT_S", str(MARK_WAIT_S))

SLOW_P2 = tuple((s, 2, 30.0) for s in STAGES)
SLOW_JOIN_P1 = (("join", 1, 30.0),)


def _batch_arrays():
    from repro_torch.data import synthetic as tsyn
    b = tsyn.figure1_scenario(n_per_route=4, points_per_leg=24, seed=0,
                              device="cpu")[0]
    return {f: getattr(b, f).numpy() for f in
            ("x", "y", "t", "valid", "traj_id")}


def _fields(o, sscr=None, rmse=None):
    """A ``DistributedDSCOutput`` as ``{field: tensor}`` (the reference
    script's names)."""
    d = {f: getattr(o.result, f) for f in LABELS + ("member_sim",
                                                   "alpha_used", "k_used")}
    for f in ("t_start", "t_end", "voting", "card", "valid", "traj_row"):
        d[f"table.{f}"] = getattr(o.table, f)
    d.update(vote=o.vote, active=o.active, sim_diag=o.sim_diag)
    if sscr is not None:
        d.update(sscr=torch.tensor(sscr), rmse=torch.tensor(rmse))
    return d


def _record(res):
    return dict(out=_fields(res.output, res.sscr, res.rmse),
                resumed_from=res.resumed_from, widen_count=res.widen_count,
                rebalance_count=res.rebalance_count,
                fallback_steps=res.fallback_steps, events=res.events)


def _port_mesh(sizes, arrays, tmp):
    """One rank of a ``sizes`` mesh: that shape's cases (module
    docstring), each result under its reference name."""
    from repro_torch.core.distributed import run_dsc_distributed
    from repro_torch.core.partitioning import (partition_batch,
                                               repartition_batch)
    from repro_torch.core.types import DSCParams, TrajectoryBatch
    from repro_torch.distributed.mesh import Mesh, current
    from repro_torch.run import (FaultPlan, InjectedCrash, RebalancePolicy,
                                 read_telemetry, run_resilient_distributed)
    batch = TrajectoryBatch.from_arrays(*arrays.values(), device="cpu")
    params = DSCParams(**FIG1)
    mesh = Mesh(sizes, "gloo", "cpu")
    P = sizes[0]
    rank0 = current().rank == 0
    got = {}

    def run(name, parts=None, **kw):
        parts = partition_batch(batch, P) if parts is None else parts
        try:
            res = run_resilient_distributed(parts, params, mesh,
                                            clock=StepClock(), **kw)
        except (InjectedCrash, ValueError, RuntimeError) as e:
            got[name] = dict(error=type(e).__name__ + ": " + str(e))
            return None
        got[name] = _record(res)
        return res

    def tel(name, root):
        got[name + "/telemetry"] = read_telemetry(f"{root}/telemetry.jsonl")

    def copy(src, dst):
        if rank0:
            shutil.copytree(src, dst)
        import torch.distributed as dist
        dist.barrier()

    def mono(name, **kw):
        o = run_dsc_distributed(partition_batch(batch, P), params, mesh,
                                **kw)
        got[name] = dict(out=_fields(o))

    if sizes == (4, 1):
        run("port_write", checkpoint_dir=f"{tmp}/port_ckpt",
            fault_plan=FaultPlan(crash_at="cluster"))
        if rank0:
            open(f"{tmp}/port_ckpt.done", "w").close()
        run("p4_fresh")
        mono("p4_mono")
        run("slow41", fault_plan=FaultPlan(slow=SLOW_P2))
        run("off41", fault_plan=FaultPlan(slow=SLOW_JOIN_P1),
            rebalance=RebalancePolicy(mode="off"))
        for stage in STAGES:
            src = f"{tmp}/el_{stage}"
            run(f"el_crash_{stage}", checkpoint_dir=src,
                fault_plan=FaultPlan(crash_at=stage))
            for newP in (2, 1):
                copy(src, f"{src}_{newP}")
        parts4 = partition_batch(batch, 4)
        root = f"{tmp}/rb"
        res = run("rb41", parts=parts4, checkpoint_dir=root,
                  fault_plan=FaultPlan(slow=SLOW_JOIN_P1),
                  rebalance=RebalancePolicy(mode="apply"))
        tel("rb41", root)
        edges = [e for e in res.events
                 if e["event"] == "rebalanced"][0]["edges"]
        run("rb41_oracle", parts=repartition_batch(
            parts4, np.asarray(edges, np.float64)))
        root = f"{tmp}/rb2"
        run("rb41_crash", checkpoint_dir=root,
            fault_plan=FaultPlan(slow=SLOW_JOIN_P1, crash_at="cluster"),
            rebalance=RebalancePolicy(mode="apply"))
        run("rb41_adopt", checkpoint_dir=root)
        tel("rb41_adopt", root)
        run("ring41_crash", checkpoint_dir=f"{tmp}/ring",
            fault_plan=FaultPlan(crash_at="similarity"), **RING)
        # the reference's P = 4 checkpoint, resumed here
        t0 = time.time()
        while not os.path.exists(f"{tmp}/ref_ckpt.done"):
            assert time.time() - t0 < MARK_WAIT_S, "no reference checkpoint"
            time.sleep(0.2)
        run("ref_resume", checkpoint_dir=f"{tmp}/ref_ckpt")
    elif sizes == (2, 2):
        run("fresh22")
        mono("mono22")
        for stage in STAGES:
            root = f"{tmp}/crash22_{stage}"
            run(f"crash22_{stage}", checkpoint_dir=root,
                fault_plan=FaultPlan(crash_at=stage))
            run(f"resume22_{stage}", checkpoint_dir=root)
            if stage == "cluster":
                tel("resume22", root)
        run("widen22", on_overflow="widen", **TOPK4)
        run("degrade22", on_overflow="degrade", **TOPK4)
        mono("mono_widen22", on_overflow="widen", **TOPK4)
        delays = []
        run("transient22", sleep=delays.append,
            fault_plan=FaultPlan(transient_at="segment", transient_count=2))
        got["transient22"]["delays"] = delays
        root = f"{tmp}/corrupt22"
        run("corrupt_crash22", checkpoint_dir=root,
            fault_plan=FaultPlan(corrupt_stage="segment",
                                 crash_at="similarity"))
        run("corrupt22", checkpoint_dir=root)
        tel("corrupt22", root)
    elif sizes == (2, 1):
        run("p2_fresh")
        run("noflag", checkpoint_dir=f"{tmp}/el_cluster_2")
        for stage in STAGES:
            root = f"{tmp}/el_{stage}_2"
            run(f"el_{stage}_2", checkpoint_dir=root, elastic_resume=True)
            tel(f"el_{stage}_2", root)
        run("ring21", checkpoint_dir=f"{tmp}/ring", elastic_resume=True,
            **RING)
        tel("ring21", f"{tmp}/ring")
        run("ring21_barrier", sim_mode="topk", sim_topk=48)
    else:
        run("p1_fresh")
        for stage in STAGES:
            root = f"{tmp}/el_{stage}_1"
            run(f"el_{stage}_1", checkpoint_dir=root, elastic_resume=True)
            tel(f"el_{stage}_1", root)
    return got


MESHES = ((4, 1), (2, 2), (2, 1), (1, 1))


def _parent_path(tmp, arrays):
    """Two runs through ``run_resilient_distributed``'s own ``spawn`` (the
    parent path): ``on_overflow="raise"`` at K = 4, and a crash at segment
    with asynchronous saves.  Returns ``{name: (exception, ...)}``."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.partitioning import partition_batch
    from repro_torch.core.types import DSCParams, TrajectoryBatch
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.run import FaultPlan, run_resilient_distributed
    batch = TrajectoryBatch.from_arrays(*arrays.values(), device="cpu")
    parts = partition_batch(batch, 2)
    mesh = Mesh((2, 1), "gloo", "cpu")
    got = {}
    try:
        run_resilient_distributed(parts, DSCParams(**FIG1), mesh,
                                  on_overflow="raise", **TOPK4)
    except Exception as e:  # noqa: BLE001 - the class is checked
        got["raise21"] = e
    root = tmp / "async_crash"
    try:
        run_resilient_distributed(parts, DSCParams(**FIG1), mesh,
                                  checkpoint_dir=root, sync_saves=False,
                                  fault_plan=FaultPlan(crash_at="segment"))
    except Exception as e:  # noqa: BLE001 - the class is checked
        mgr = CheckpointManager(root)
        got["async_crash"] = (e, mgr.available_steps(),
                              sorted(mgr.restore_flat(1)[0]))
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference arrays, reference report, port {mesh: [per-rank
    results]}, parent-path results, tmp)``."""
    from repro_torch.distributed.mesh import Mesh, spawn
    tmp = tmp_path_factory.mktemp("rdist")
    arrays = _batch_arrays()
    np.savez(tmp / "data.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_SCRIPT, str(tmp),
         str(tmp / "data.npz"), json.dumps(FIG1), str(tmp / "ref.npz"),
         str(tmp / "ref.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = {m: spawn(_port_mesh, Mesh(m, "gloo", "cpu"), m, arrays,
                         str(tmp), threads=1, timeout=600) for m in MESHES}
        parent = _parent_path(tmp, arrays)
        _, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    return (dict(np.load(tmp / "ref.npz")),
            json.loads((tmp / "ref.json").read_text()), port, parent, tmp)


def _port(runs, mesh, name, rank=0):
    return runs[2][mesh][rank][name]


def _same(a, b, what):
    """Two ``_fields`` dicts bit for bit."""
    assert a.keys() == b.keys(), what
    for f in a:
        assert a[f].dtype == b[f].dtype and torch.equal(a[f], b[f]), \
            (what, f)


def _close(name, got, ref, want=None):
    """The port's fields against the reference's run ``want`` (default
    ``name``), with the stated tolerances."""
    want = want or name
    for f, t in got.items():
        if f in ("alpha_used", "k_used", "sscr", "rmse"):
            continue
        g, w = t.numpy(), ref[f"{want}/{f}"]
        assert g.shape == w.shape and g.dtype == w.dtype, (name, f)
        if f in LABELS + ("active",) or f[6:] in TABLE_EQ:
            assert np.array_equal(g, w), (name, f)
        elif f in ("vote", "table.voting"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=f"{name} {f}")
        elif f == "sim_diag":
            assert np.array_equal(g[:, 3], w[:, 3]), (name, f)
            np.testing.assert_allclose(g[:, :3], w[:, :3], rtol=1e-5,
                                       err_msg=f"{name} {f}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       err_msg=f"{name} {f}")


def _events(evs):
    out = []
    for e in evs:
        e = {k: v for k, v in e.items() if k not in CLOCK_FIELDS}
        if e["event"] == "checkpoint_fallback":
            e.pop("error")
        out.append(e)
    return out


def test_fresh_run_equals_monolith_and_reference(runs):
    """A fresh staged run is bitwise the port's monolith, on every rank,
    and gives the reference's staged run (labels equal, floats to the
    stated tolerances), at (2, 2) and (4, 1)."""
    for mesh, name, mono in (((2, 2), "fresh22", "mono22"),
                             ((4, 1), "p4_fresh", "p4_mono")):
        got = _port(runs, mesh, name)["out"]
        for rank in range(len(runs[2][mesh])):
            want = dict(_port(runs, mesh, mono, rank)["out"],
                        sscr=got["sscr"], rmse=got["rmse"])
            _same(_port(runs, mesh, name, rank)["out"], want, name)
        _close(name, got, runs[0])


@pytest.mark.parametrize("stage", STAGES)
def test_crash_and_resume_bitwise(runs, stage):
    """A crash at ``stage`` on (2, 2) resumes from the stage before it,
    bitwise the straight run on every rank."""
    for rank, r in enumerate(runs[2][(2, 2)]):
        assert r[f"crash22_{stage}"]["error"] == \
            f"InjectedCrash: injected crash at stage {stage!r}"
        res = r[f"resume22_{stage}"]
        assert res["resumed_from"] == STAGES.index(stage)
        _same(res["out"], r["fresh22"]["out"], (stage, rank))


def test_widen_degrade_and_raise(runs):
    """Widen from K = 4 recovers the dense labels with the reference's
    widen count (and the monolith's widen gives the same labels); degrade
    keeps the reference's certificate count; ``raise`` raises
    ``OverflowViolation`` in the parent with the reference's message."""
    ref, rep = runs[0], runs[1]
    w = _port(runs, (2, 2), "widen22")
    assert w["widen_count"] == rep["widen22"]["widen_count"] >= 1
    assert int(w["out"]["sim_diag"][:, 3].sum()) == 0
    for f in LABELS:
        assert torch.equal(w["out"][f], _port(runs, (2, 2), "fresh22")
                           ["out"][f]), f
        assert torch.equal(_port(runs, (2, 2), "mono_widen22")["out"][f],
                           w["out"][f]), f
    _close("widen22", w["out"], ref)
    d = _port(runs, (2, 2), "degrade22")
    assert int(d["out"]["sim_diag"][:, 3].sum()) == \
        int(ref["degrade22/sim_diag"][:, 3].sum()) > 0
    _close("degrade22", d["out"], ref)
    exc = runs[3]["raise21"]
    assert type(exc).__name__ == "OverflowViolation"
    from repro_torch.run import OverflowViolation
    assert isinstance(exc, OverflowViolation)
    assert rep["raise21"]["error"] == f"OverflowViolation: {exc}"


def test_classified_failure_crosses_spawn_after_the_save(runs):
    """A crash raised on every rank comes back from the parent path with
    its class and message, and rank 0's asynchronous save of the stage
    before it has landed, whole."""
    from repro_torch.run import InjectedCrash
    exc, steps, leaves = runs[3]["async_crash"]
    assert type(exc) is InjectedCrash
    assert str(exc) == "injected crash at stage 'segment'"
    assert steps == [1]
    assert "vote" in leaves and "meta/edges" in leaves


def test_straggler_flags_and_suggested_edges(runs):
    """A scripted slowdown of partition 2 at every stage flags it at every
    stage with the reference's suggested edges (float64, exact); the
    telemetry is the reference's, event for event."""
    rep = runs[1]
    evs = _port(runs, (4, 1), "slow41")["events"]
    flags = [e for e in evs if e["event"] == "straggler_flagged"]
    sugg = [e for e in evs if e["event"] == "rebalance_suggestion"]
    assert len(flags) == len(STAGES)
    assert all("2" in e["partitions"] for e in flags)
    want = [e for e in rep["slow41"]["events"]
            if e["event"] == "rebalance_suggestion"]
    assert [e["edges"] for e in sugg] == [e["edges"] for e in want]
    assert len(sugg[-1]["edges"]) == 5
    assert _events(evs) == _events(rep["slow41"]["events"])
    for r in runs[2][(4, 1)][1:]:
        assert _events(r["slow41"]["events"]) == _events(evs)


def test_rebalance_off_is_silent(runs):
    evs = _port(runs, (4, 1), "off41")["events"]
    assert not any(e["event"] in ("rebalance_suggestion", "rebalanced")
                   for e in evs)
    assert _events(evs) == _events(runs[1]["off41"]["events"])


@pytest.mark.parametrize("newP", [2, 1])
@pytest.mark.parametrize("stage", STAGES)
def test_elastic_resume_bitwise(runs, stage, newP):
    """A P = 4 checkpoint crashed at ``stage`` resumes at P = ``newP``
    bitwise a straight run there, with the reference's ``resumed_from``,
    labels and telemetry."""
    mesh = (newP, 1)
    rep = runs[1]
    assert _port(runs, (4, 1), f"el_crash_{stage}")["error"] == \
        rep[f"el_crash_{stage}"]["error"]
    name = f"el_{stage}_{newP}"
    got = _port(runs, mesh, name)
    assert got["resumed_from"] == rep[name]["resumed_from"] == \
        min(STAGES.index(stage), 2)
    for r in runs[2][mesh]:
        _same(r[name]["out"], r[f"p{newP}_fresh"]["out"], name)
    _close(name, got["out"], runs[0])
    assert _events(got["events"]) == _events(rep[name]["events"])
    assert _events(_port(runs, mesh, name + "/telemetry")) == \
        _events(rep[name + "/telemetry"])


def test_cross_p_resume_without_flag_refuses(runs):
    got = _port(runs, (2, 1), "noflag")["error"]
    assert got == runs[1]["noflag"]["error"]
    assert got.startswith("ValueError: ") and "elastic_resume" in got


def test_rebalance_apply_and_adopt(runs):
    """An applied rebalance after the join (partition 1 slowed there) is
    bitwise a straight run at its cut, with the reference's edges; a crash
    after it resumes on the same mesh by adopting the checkpoint's edges,
    bitwise the rebalanced run; telemetry is the reference's."""
    rep = runs[1]
    rb = _port(runs, (4, 1), "rb41")
    assert rb["rebalance_count"] == rep["rb41"]["rebalance_count"] == 1
    applied = [e for e in rb["events"] if e["event"] == "rebalanced"]
    assert len(applied) == 1 and applied[0]["stage"] == "join"
    assert applied[0]["edges"] == [
        e for e in rep["rb41"]["events"] if e["event"] == "rebalanced"][0][
        "edges"]
    _same(rb["out"], _port(runs, (4, 1), "rb41_oracle")["out"], "rb41")
    _close("rb41", rb["out"], runs[0])
    ad = _port(runs, (4, 1), "rb41_adopt")
    assert ad["resumed_from"] == rep["rb41_adopt"]["resumed_from"] == 3
    assert [e["event"] for e in ad["events"]].count(
        "elastic_adopt_edges") == 1
    _same(ad["out"], rb["out"], "rb41_adopt")
    for name in ("rb41/telemetry", "rb41_adopt/telemetry"):
        assert _events(_port(runs, (4, 1), name)) == _events(rep[name])


def test_ring_crash_resumes_elastically(runs):
    """A ring-plan crash at similarity on (4, 1) resumes on (2, 1) with
    ``elastic_resume``, bitwise the barrier plan's straight run there; the
    telemetry carries the ring schedule, as the reference's."""
    rep = runs[1]
    got = _port(runs, (2, 1), "ring21")
    assert got["resumed_from"] == rep["ring21"]["resumed_from"] == 2
    _same(got["out"], _port(runs, (2, 1), "ring21_barrier")["out"], "ring")
    _close("ring21", got["out"], runs[0])
    done = [e for e in _port(runs, (2, 1), "ring21/telemetry")
            if e["event"] == "stage_done"]
    assert done[0]["comm"] == {"halo_stream": "ring", "sim_exchange": "ring"}
    assert _events(_port(runs, (2, 1), "ring21/telemetry")) == \
        _events(rep["ring21/telemetry"])


def test_telemetry_matches_reference(runs):
    """A crash at cluster and its resume on (2, 2): the telemetry file is
    the reference's, event for event, and rank 0 alone wrote it."""
    rep = runs[1]
    got = _port(runs, (2, 2), "resume22/telemetry")
    assert _events(got) == _events(rep["resume22/telemetry"])
    assert [e["event"] for e in got].count("run_start") == 2
    for r in runs[2][(2, 2)][1:]:
        assert r["resume22/telemetry"] == got


def test_transient_retries_same_on_every_rank(runs):
    rep = runs[1]["transient22"]
    for r in runs[2][(2, 2)]:
        got = r["transient22"]
        assert got["delays"] == rep["delays"] == [0.5, 1.0]
        assert _events(got["events"]) == _events(rep["events"])
        _same(got["out"], r["fresh22"]["out"], "transient")


def test_corrupt_checkpoint_same_on_every_rank(runs):
    """A corrupted segment checkpoint (written by rank 0) is discarded on
    every rank at the resume, which restarts from the join checkpoint,
    bitwise the straight run; only rank 0's telemetry file holds the
    fallback event, and it is the reference's."""
    rep = runs[1]
    for r in runs[2][(2, 2)]:
        got = r["corrupt22"]
        assert got["fallback_steps"] == rep["corrupt22"]["fallback_steps"] \
            == [2]
        assert got["resumed_from"] == rep["corrupt22"]["resumed_from"] == 1
        _same(got["out"], r["fresh22"]["out"], "corrupt")
    assert _events(_port(runs, (2, 2), "corrupt22/telemetry")) == \
        _events(rep["corrupt22/telemetry"])


def test_checkpoints_cross_packages(runs):
    """The reference's P = 4 checkpoint resumes in the port and the
    port's in the reference, each with the writer's straight-run labels;
    both packages write the same leaves (names, shapes, dtypes)."""
    from repro_torch.checkpoint import load_checkpoint_flat
    ref, rep, _, _, tmp = runs
    assert rep["ref_write"]["error"] == _port(runs, (4, 1), "port_write")[
        "error"]
    got = _port(runs, (4, 1), "ref_resume")
    assert got["resumed_from"] == 3
    _close("ref_resume", got["out"], ref, want="p4_fresh")
    assert rep["port_resume"]["resumed_from"] == 3
    port = _port(runs, (4, 1), "p4_fresh")["out"]
    for f in LABELS:
        assert np.array_equal(ref[f"port_resume/{f}"], port[f].numpy()), f
    for step in (1, 2, 3):
        t, _ = load_checkpoint_flat(tmp / "ref_ckpt", step)
        j, _ = load_checkpoint_flat(tmp / "port_ckpt", step)
        assert list(t) == list(j), step
        for k in t:
            assert (t[k].dtype, t[k].shape) == (j[k].dtype, j[k].shape), k
