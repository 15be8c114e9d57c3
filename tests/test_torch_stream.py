"""PyTorch port: the streaming service held against the JAX package's
(``tests/test_stream.py``, on the port, at its ``t_cap = 16`` size).

On the CPU:

* the host side (ingest, watermark, backpressure, ``stream_records``,
  ``dirtify``) is a copy: counters, logs and records equal the
  reference's on the same input;
* the port's stream equals the port's batch oracle ``run_dsc(window_batch,
  sim_mode="topk", on_overflow="degrade")`` **bitwise** at every advance
  (lists, spill, labels), with and without eviction, with the delta join
  and the fresh block cut into chunks, under chaos;
* warm start equals cold start; kill and resume at every advance lands on
  the uninterrupted run bitwise;
* the reference's stream gives equal labels and list ids, and
  similarities equal to 2.4e-7 (two ulps near 1): the reference's
  interpreted join contracts ``dx*dx + dy*dy`` into an FMA, one ulp off
  the port's IEEE formula (``ROADMAP.md`` Queue 3, stated in
  ``tests/test_torch_join.py``), and a similarity sums such weights;
* snapshots interchange: the port resumes from a reference snapshot and
  the reference from a port snapshot, each ending with the reference's
  labels.
"""
import json

import numpy as np
import pytest
import torch

import repro_torch.stream.driver as drv_mod
from repro.data import synthetic as jsyn
from repro.run.faults import FaultPlan as JFaultPlan
from repro.serve.stream import StreamService as JService
from repro.stream import Ingestor as JIngestor
from repro.stream import Records as JRecords
from repro.stream import StreamConfig as JConfig
from repro.stream import WindowManager as JWindow
from repro_torch.core.dsc import run_dsc
from repro_torch.core.plan import EnginePlan
from repro_torch.data.synthetic import (dirtify, figure1_scenario,
                                        stream_records)
from repro_torch.run.faults import FaultInjector, FaultPlan, InjectedCrash
from repro_torch.run.resilient import Telemetry, read_telemetry
from repro_torch.serve.stream import StreamService
from repro_torch.stream import (BackpressureOverflow, Ingestor,
                                PoisonRecord, Records, StreamConfig,
                                StreamDriver, WatermarkStall, WindowManager)

pytestmark = pytest.mark.stream

torch.set_num_threads(1)

# the reference's stream against the port's: similarities (a sum of join
# weights, each within one ulp) to this absolute tolerance
SIM_ATOL = 2.4e-7
STATE = ("standing_ids", "standing_sims", "member_of", "member_sim",
         "is_rep", "is_outlier")


def small_config(**kw):
    base = dict(t_cap=16, m_cap=16, eps_sp=0.3, eps_t=2.0, alpha_abs=0.1,
                k_abs=0.0, allowed_lateness=4.0, horizon=1000.0,
                max_subs=4, k=8, w=2)
    base.update(kw)
    return StreamConfig(**base)


def small_stream(batch_size=24, **kw):
    batch, _ = figure1_scenario(n_per_route=2, points_per_leg=8,
                                device="cpu", **kw)
    return batch, stream_records(batch, batch_size=batch_size)


def service(cfg, **kw):
    return StreamService(cfg, device="cpu", **kw)


def drive(cfg, batches, **kw):
    svc = service(cfg, **kw)
    svc.run(batches)
    return svc


def assert_matches_batch_oracle(drv):
    """Standing lists, spill and labels == the port's run_dsc over the
    same window, bitwise."""
    K = drv.config.k
    out = run_dsc(drv.window_batch(), drv.config.params,
                  plan=EnginePlan(sim_mode="topk", sim_topk=K),
                  on_overflow="degrade", device="cpu")
    assert torch.equal(out.sim_topk.ids, drv.standing_ids[:, :K])
    assert torch.equal(out.sim_topk.sims, drv.standing_sims[:, :K])
    assert torch.equal(out.sim_topk.spill, drv.standing_sims[:, K])
    for f in ("member_of", "member_sim", "is_rep", "is_outlier"):
        assert torch.equal(getattr(out.result, f), getattr(drv, f)), f


# ------------------------------------------------- host side: the copies

def _jrecs(r):
    return JRecords(*(np.array(getattr(r, f)) for f in Records._fields))


def test_ingest_matches_reference():
    """The quarantine matrix of the reference's test, on both copies."""
    books = []
    for cls, rec in ((Ingestor, Records), (JIngestor, JRecords)):
        ing = cls(on_dirty="drop", max_speed=1.0)
        ing.process(rec.build([1], [0.0], [0.0], [0.0]))
        out = ing.process(rec.build([1, 1, 1, 1, 1],
                                    [np.nan, 1.0, 1.1, 99.0, 1.2],
                                    [0.0] * 5, [1.0, 2.0, 1.5, 3.0, 4.0]))
        dup = ing.process(rec.build([1], [1.2], [0.0], [4.0]))
        books.append((out.n, dup.n, dict(ing.counters), ing.submitted,
                      ing.admitted, ing.quarantine_log(),
                      {k: v.tolist() for k, v in
                       ing.state_arrays().items()}))
    assert books[0] == books[1]
    assert books[0][2] == {"nonfinite": 1, "duplicate": 1,
                           "non_monotone": 1, "teleport": 1}


def test_ingest_repair_and_fail():
    rep = Ingestor(on_dirty="repair")
    out = rep.process(Records.build([5, 5, 5], [0.0, 1.0, 2.0], [0.0] * 3,
                                    [2.0, 1.0, 3.0]))
    assert list(out.t) == [1.0, 2.0, 3.0] and rep.repaired_order > 0
    with pytest.raises(PoisonRecord):
        Ingestor(on_dirty="fail").process(
            Records.build([1], [np.nan], [0.0], [0.0]))


def test_stream_records_and_dirtify_match_reference():
    batch, batches = small_stream()
    jb, _ = jsyn.figure1_scenario(n_per_route=2, points_per_leg=8)
    for order in ("time", "traj"):
        mine = stream_records(batch, batch_size=24, order=order)
        ref = jsyn.stream_records(jb, batch_size=24, order=order)
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            for f in Records._fields:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    kw = dict(dup_frac=0.1, nan_frac=0.05, teleport_frac=0.05,
              swap_frac=0.2, seed=11)
    d, t = dirtify(batches, **kw)
    jd, jt = jsyn.dirtify([_jrecs(r) for r in batches], **kw)
    assert t == jt and t["dup"] > 0 and t["nan"] > 0
    for a, b in zip(d, jd):
        for f in Records._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    ing = Ingestor(on_dirty="drop", max_speed=5.0)
    dirty, truth = dirtify(batches, seed=7, nan_frac=0.1)
    for recs in dirty:
        ing.process(recs)
    assert ing.counters["nonfinite"] == truth["nan"] > 0


def test_window_matches_reference():
    books = []
    for cls, rec, stall, bp in ((WindowManager, Records, WatermarkStall,
                                 BackpressureOverflow),
                                (JWindow, JRecords, None, None)):
        wm = cls(allowed_lateness=2.0, horizon=10.0, queue_cap=5,
                 stall_advances=3)
        shed = [wm.stage(rec.build(np.arange(4), np.zeros(4), np.zeros(4),
                                   off + np.arange(4, dtype=float)))
                for off in (6.0, 10.0)]
        admitted, late = wm.drain()
        wm.stage(rec.build([1], [0], [0], [3.0]))
        admitted2, late2 = wm.drain()
        books.append((shed, admitted.n, late, admitted2.n, late2,
                      wm.watermark, wm.evict_before(),
                      {k: v.tolist() for k, v in wm.state_arrays().items()}))
        if stall is not None:
            blk = cls(allowed_lateness=5.0, horizon=10.0, queue_cap=5,
                      policy="block", stall_advances=1)
            with pytest.raises(bp):
                blk.stage(rec.build(np.arange(6), np.zeros(6), np.zeros(6),
                                    np.arange(6, dtype=float)))
            blk.stage(rec.build([1], [0], [0], [100.0]))
            blk.drain()
            blk.stage(rec.build([1], [0], [0], [10.0]))
            with pytest.raises(stall):
                blk.drain()
    assert books[0] == books[1]


# ------------------------------------------------- streaming == batch DSC

@pytest.mark.parametrize("kw", [{}, dict(horizon=8.0, allowed_lateness=2.0),
                                dict(segmentation="tsa2", w=3)],
                         ids=["window", "eviction", "tsa2"])
def test_streaming_matches_batch_at_every_advance(kw):
    _, batches = small_stream()
    svc = service(small_config(**kw))
    evicted = 0
    for recs in batches:
        svc.driver.submit(recs)
        evicted += svc.driver.advance().get("evicted", 0)
        assert_matches_batch_oracle(svc.driver)
    assert svc.accounting()["balanced"] and svc.stats()["reps"] > 0
    assert (evicted > 0) == ("horizon" in kw)


def test_chunked_delta_join_and_fresh_block(monkeypatch):
    """Delta-join chunks of 3 rows and fresh-block chunks of 2 rows give
    the oracle's state, bitwise."""
    monkeypatch.setattr(drv_mod, "JOIN_ELEMENTS", 16 * 16 * 3)
    monkeypatch.setattr(drv_mod, "FRESH_ELEMENTS", 4 * 64 * 2)
    _, batches = small_stream()
    svc = service(small_config(horizon=8.0, allowed_lateness=2.0))
    for recs in batches:
        svc.driver.submit(recs)
        svc.driver.advance()
        assert_matches_batch_oracle(svc.driver)


def test_warm_start_equals_cold_start():
    _, batches = small_stream()
    warm = drive(small_config(warm_start=True), batches)
    cold = drive(small_config(warm_start=False), batches)
    for attr in STATE:
        assert torch.equal(getattr(warm.driver, attr),
                           getattr(cold.driver, attr)), attr
    assert warm.driver.warm_prefix > 0 == cold.driver.warm_prefix


def test_warm_clustering_operands_fit_the_list_kernels(monkeypatch):
    """The warm clustering hands K8 and K9 what their launchers accept
    (packed int32 / float32 lists, int32 ranks, bool vectors on one
    device), and runs the plain engine on the CPU."""
    from repro_torch.core.clustering import visit_order
    from repro_torch.kernels.cluster.ops import _check_lists
    real, calls = drv_mod.cluster_rounds_topk, []

    def checked(topk, table, params, **kw):
        _, rank = visit_order(table)
        _check_lists("topk_claim_max", topk.ids, topk.sims, rank,
                     is_rep=kw["seed_is_rep"], valid=table.valid,
                     unresolved=kw["seed_resolved"])
        calls.append(kw["use_kernel"])
        return real(topk, table, params, **kw)

    monkeypatch.setattr(drv_mod, "cluster_rounds_topk", checked)
    _, batches = small_stream()
    svc = drive(small_config(), batches)
    assert calls and not any(calls)
    assert_matches_batch_oracle(svc.driver)


def test_row_capacity_overflow_drops_oldest_and_counts():
    drv = StreamDriver(small_config(t_cap=4, m_cap=4,
                                    allowed_lateness=100.0), device="cpu")
    drv.submit(Records.build([7] * 6, np.arange(6, dtype=float),
                             np.zeros(6), np.arange(6, dtype=float)))
    drv.advance()
    assert drv.row_overflow == 2
    r = drv._row_of[7]
    np.testing.assert_array_equal(drv.ts[r][drv.valid[r]],
                                  [2.0, 3.0, 4.0, 5.0])
    assert drv.accounting()["balanced"]


def test_stream_matches_reference_stream():
    """The reference's service on the same submissions: labels and list
    ids equal, similarities within SIM_ATOL, books equal."""
    _, batches = small_stream()
    cfg = small_config(horizon=8.0, allowed_lateness=2.0)
    svc = service(cfg)
    jsvc = JService(JConfig(**cfg.to_dict()))
    assert JConfig(**cfg.to_dict()).fingerprint() == cfg.fingerprint()
    for recs in batches:
        svc.driver.submit(recs)
        jsvc.driver.submit(_jrecs(recs))
        assert svc.driver.advance() == jsvc.driver.advance()
        for f in STATE:
            got = getattr(svc.driver, f).numpy()
            want = np.asarray(getattr(jsvc.driver, f))
            if f in ("standing_sims", "member_sim"):
                np.testing.assert_allclose(got, want, rtol=0, atol=SIM_ATOL)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f)
    assert svc.stats() == jsvc.stats()
    assert svc.accounting() == jsvc.accounting()


# ---------------------------------------------------------- kill + resume

def fingerprint(svc):
    d = svc.driver
    return {**{f: getattr(d, f).clone() for f in STATE},
            "valid": d.valid.copy(), "ts": d.ts.copy(),
            "cube_w": d.cube_w.clone(), "cube_idx": d.cube_idx.clone(),
            "quarantine": dict(d.ingest.counters), "stats": svc.stats(),
            "accounting": svc.accounting(),
            "qlog": d.ingest.quarantine_log()}


def assert_same_state(a, b):
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    _, batches = small_stream()
    cfg = small_config(snapshot_every=1)
    svc = service(cfg, checkpoint_dir=str(tmp_path_factory.mktemp("ref")))
    svc.run(batches)
    return cfg, batches, fingerprint(svc)


@pytest.mark.parametrize("kill_at", range(1, 8))
def test_kill_and_resume_at_every_advance(uninterrupted, kill_at, tmp_path):
    cfg, batches, ref = uninterrupted
    ck = str(tmp_path / "kill")
    svc = service(cfg, checkpoint_dir=ck, injector=FaultInjector(
        FaultPlan(crash_at_advance=kill_at)))
    with pytest.raises(InjectedCrash):
        svc.run(batches)
    svc2 = service(cfg, checkpoint_dir=ck)
    assert svc2.resumed and svc2.driver.advance_count == kill_at
    svc2.run(batches)
    assert_same_state(ref, fingerprint(svc2))


def test_resume_refuses_other_config_and_full_queue(tmp_path):
    _, batches = small_stream()
    cfg = small_config(snapshot_every=1)
    svc = service(cfg, checkpoint_dir=str(tmp_path / "ck"))
    svc.run(batches[:2])
    with pytest.raises(ValueError, match="different schema/config"):
        service(small_config(snapshot_every=1, eps_sp=0.31),
                checkpoint_dir=str(tmp_path / "ck"))
    drv = StreamDriver(cfg, checkpoint_dir=str(tmp_path / "q"),
                       device="cpu")
    drv.submit(batches[0])
    with pytest.raises(RuntimeError, match="staging queue"):
        drv.snapshot()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshots_interchange(writer, tmp_path):
    """A service killed at advance 3 in one package resumes in the other
    (the same config fingerprint) and ends with the reference's labels
    and list ids."""
    _, batches = small_stream()
    cfg = small_config(snapshot_every=1)
    jcfg = JConfig(**cfg.to_dict())
    jbatches = [_jrecs(r) for r in batches]
    ck = str(tmp_path / "ck")
    if writer == "reference":
        from repro.run.faults import FaultInjector as JInjector
        jsvc = JService(jcfg, checkpoint_dir=ck, injector=JInjector(
            JFaultPlan(crash_at_advance=3)))
        with pytest.raises(Exception, match="injected crash"):
            jsvc.run(jbatches)
        svc = service(cfg, checkpoint_dir=ck)
        assert svc.resumed and svc.driver.advance_count == 3
        svc.run(batches)
        got = {f: getattr(svc.driver, f).numpy() for f in STATE}
    else:
        svc = service(cfg, checkpoint_dir=ck, injector=FaultInjector(
            FaultPlan(crash_at_advance=3)))
        with pytest.raises(InjectedCrash):
            svc.run(batches)
        jsvc = JService(jcfg, checkpoint_dir=ck)
        assert jsvc.resumed and jsvc.driver.advance_count == 3
        jsvc.run(jbatches)
        got = {f: np.asarray(getattr(jsvc.driver, f)) for f in STATE}
    want = JService(jcfg)
    want.run(jbatches)
    for f in STATE:
        w = np.asarray(getattr(want.driver, f))
        if f in ("standing_sims", "member_sim"):
            np.testing.assert_allclose(got[f], w, rtol=0, atol=SIM_ATOL)
        else:
            np.testing.assert_array_equal(got[f], w, err_msg=f)


# ------------------------------------------------------------ chaos suite

def test_chaos_never_crashes_and_accounts_for_everything():
    _, batches = small_stream()
    plan = FaultPlan(stream_late_burst=((2, 50.0), (5, 120.0)),
                     stream_dup_storm=(3, 6), stream_poison=((1, 4),),
                     stream_stall=(4,))
    svc = service(small_config(max_speed=100.0),
                  injector=FaultInjector(plan))
    svc.run(batches)
    acc = svc.accounting()
    assert acc["balanced"], acc
    assert acc["quarantined"] > 0 and acc["late_dropped"] > 0
    assert svc.driver.ingest.counters["nonfinite"] >= 1
    assert svc.driver.ingest.counters["duplicate"] > 0


def test_chaos_dirty_stream_still_matches_batch_of_admitted():
    _, batches = small_stream()
    dirty, _ = dirtify(batches, dup_frac=0.1, nan_frac=0.05, seed=3)
    plan = FaultPlan(stream_poison=((0, 2), (3, 7)))
    svc = service(small_config(), injector=FaultInjector(plan))
    svc.run(dirty)
    assert svc.accounting()["balanced"]
    assert_matches_batch_oracle(svc.driver)


def test_stall_batches_defer_advance():
    _, batches = small_stream()
    plan = FaultPlan(stream_stall=tuple(range(len(batches) - 1)))
    svc = service(small_config(), injector=FaultInjector(plan))
    svc.run(batches)
    assert svc.driver.advance_count == 1
    assert svc.accounting()["balanced"]


def test_stream_telemetry_matches_reference(tmp_path):
    """The same chaos on both services writes the same events, field for
    field but the clock."""
    _, batches = small_stream()
    plan = dict(stream_late_burst=((2, 80.0),), stream_poison=((1, 0),))
    from repro.run.faults import FaultInjector as JInjector
    from repro.run.resilient import Telemetry as JTelemetry
    clock = iter(range(1000)).__next__
    svc = service(small_config(queue_cap=16),
                  telemetry=Telemetry(tmp_path / "t.jsonl", clock),
                  injector=FaultInjector(FaultPlan(**plan)))
    svc.run(batches)
    jclock = iter(range(1000)).__next__
    jsvc = JService(JConfig(**small_config(queue_cap=16).to_dict()),
                    telemetry=JTelemetry(tmp_path / "j.jsonl", jclock),
                    injector=JInjector(JFaultPlan(**plan)))
    jsvc.run([_jrecs(r) for r in batches])
    events = read_telemetry(tmp_path / "t.jsonl")
    assert events == read_telemetry(tmp_path / "j.jsonl")
    names = {e["event"] for e in events}
    assert {"window_advanced", "record_quarantined", "late_dropped",
            "backpressure"} <= names


def test_stream_config_validation():
    with pytest.raises(ValueError, match="absolute thresholds"):
        small_config(alpha_abs=-1.0).validate()
    with pytest.raises(ValueError, match="horizon"):
        small_config(horizon=1.0, allowed_lateness=5.0).validate()
    with pytest.raises(ValueError, match="segmentation"):
        small_config(segmentation="nope").validate()
    cfg = small_config()
    assert StreamConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.fingerprint() != small_config(eps_sp=0.31).fingerprint()
    assert json.dumps(cfg.to_dict(), sort_keys=True) == json.dumps(
        JConfig(**cfg.to_dict()).to_dict(), sort_keys=True)


def test_query_api_matches_reference():
    _, batches = small_stream()
    svc = drive(small_config(), batches)
    jsvc = JService(JConfig(**small_config().to_dict()))
    jsvc.run([_jrecs(r) for r in batches])
    seen_rep = False
    for obj in svc.driver.obj_of_row:
        if obj < 0:
            continue
        q = svc.query(int(obj))
        assert q == jsvc.query(int(obj))
        seen_rep |= any(s["is_rep"] for s in q["subtrajs"])
    assert seen_rep and not svc.query(99999)["in_window"]
