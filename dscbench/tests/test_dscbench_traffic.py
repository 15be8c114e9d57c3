"""A traffic's fixed set of slices (``slice_seeds``), with the seed's own
slice checked after the window, and what a traffic without them keeps
doing; K7's roofline reader on a stub trace."""
import json
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT, SEED, tiny

from dscbench import generator, harness, roofline, trace


def _recorded(monkeypatch):
    """Every ``(seed, slice)`` that the harness makes from now on."""
    seen = []
    make = generator.make_slice

    def recording(config, seed):
        seen.append((seed, make(config, seed)))
        return seen[-1][1]

    monkeypatch.setattr(generator, "make_slice", recording)
    return seen


def _run(cell, seconds, seed=SEED):
    return harness.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                            time.perf_counter())


def test_fixed_slices_do_not_follow_the_seed(monkeypatch):
    cell = tiny(harness.load_cell("brest.topk"))
    assert harness.slice_seeds(cell.traffic, SEED) == \
        harness.slice_seeds(cell.traffic, 7) == cell.traffic["slice_seeds"]
    cell.traffic = dict(cell.traffic, slices=2, slice_seeds=[3, 1])
    seen = _recorded(monkeypatch)
    res, lines = _run(cell, 0.01, seed=SEED)
    res2, _ = _run(cell, 0.01, seed=SEED + 99)
    assert [s for s, _ in seen] == [3, 1, SEED, 3, 1, SEED + 99]
    for (_, a), (_, b) in zip(seen[:2], seen[3:5]):
        assert all(np.array_equal(x, y) for x, y in
                   zip((a.x, a.y, a.t, a.valid, a.traj_id),
                       (b.x, b.y, b.t, b.valid, b.traj_id)))
        assert a.params == b.params
    assert res["correct"] and res2["correct"]
    assert res["checks"] == res2["checks"]
    assert any(ln.startswith("slice 0: seed 3,") for ln in lines)
    assert any(ln.startswith(f"the seed's slice: seed {SEED},")
               for ln in lines)


class AlteredAfterWindow(harness.Program):
    """One label altered in the job after the window alone: the seed's
    own slice (the fixed slices' jobs are exact)."""

    def __init__(self, cell, device, skip):
        super().__init__(cell, device)
        self.calls, self.skip = 0, skip

    def run(self, batch, params, stage_times):
        out = super().run(batch, params, stage_times)
        self.calls += 1
        if self.calls > self.skip:
            r = out.result
            s = int(torch.nonzero(~r.is_rep & (r.member_of >= 0))[0, 0])
            r.member_of = r.member_of.clone()
            r.member_of[s] = -1
        return out


def test_a_fault_in_the_seed_slice_comes_out_not_correct():
    """Two warm-up jobs and one in the window are exact; the seed's slice,
    run after the window, has a label altered."""
    cell = tiny(harness.load_cell("brest.topk"))
    cell.traffic = dict(cell.traffic, slices=2, slice_seeds=[0, 1])
    prog = AlteredAfterWindow(cell, torch.device("cpu"), skip=3)
    res, lines = harness.run_cell(cell, SEED, 0.01, False,
                                  torch.device("cpu"), time.perf_counter(),
                                  program=prog)
    assert res["attempted"] == 1 and prog.calls == 4
    assert res["correct"] is False
    assert res["checks"]["labels"]["value"] >= 1
    assert res["checks"]["topk_lists"]["value"] == 0


def test_a_failed_check_job_comes_out_not_correct(monkeypatch):
    """A job on the seed's slice that raises reads NaN, not a pass."""
    cell = tiny(harness.load_cell("brest.topk"))
    cell.traffic = dict(cell.traffic, slices=2, slice_seeds=[0, 1])
    prog = harness.Program(cell, torch.device("cpu"))
    runs = []

    def job(*a, timed):
        runs.append(timed)
        if len(runs) == 4:
            raise RuntimeError("lost")
        return harness.Program.job(prog, *a, timed=timed)

    monkeypatch.setattr(prog, "job", job)
    res, _ = harness.run_cell(cell, SEED, 0.01, False, torch.device("cpu"),
                              time.perf_counter(), program=prog)
    assert len(runs) == 4 and res["failed"] == 0
    assert res["correct"] is False
    assert all(v["value"] != v["value"] for v in res["checks"].values())


def test_traffic_without_the_keys_is_unchanged(monkeypatch):
    """Slices from seed + i, and the closed loop stops at the first job
    that ends after the deadline."""
    cell = tiny(harness.load_cell("brest.dense"))
    cell.traffic = dict(cell.traffic, slices=2)
    assert harness.slice_seeds(cell.traffic, SEED) == [SEED, SEED + 1]
    seen = _recorded(monkeypatch)
    res, _ = _run(cell, 0.01)
    assert [s for s, _ in seen] == [SEED, SEED + 1]
    assert res["correct"] and res["attempted"] == 1
    arr = harness.Arrivals(cell.traffic)
    assert [arr.done(0.0, n, 1.0, 1.0) for n in (1, 2, 3)] == [True] * 3
    assert not arr.done(0.0, 2, 0.9, 1.0)


BAD = [
    dict(slices=4, slice_seeds=[0, 1, 2]),
    dict(slices=2, slice_seeds=[0, 1, 2]),
    dict(slices=2, slice_seeds=[0, 1.0]),
    dict(slices=2, slice_seeds=[0, True]),
    dict(slices=2, slice_seeds="01"),
    dict(slices=2, slice_seeds=[]),
    dict(slices=1, slice_seeds=[None]),
]


@pytest.mark.parametrize("bad", BAD)
def test_malformed_traffic_is_refused(bad):
    with pytest.raises(ValueError, match="traffic 'x'"):
        harness.check_traffic(dict(plan="fused_topk", **bad), "x")


def test_mismatch_is_refused_when_the_cell_loads(tmp_path):
    base = tmp_path / "dscbench"
    shutil.copytree(ROOT / "dscbench", base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = base / "workloads" / "topk_jobs.json"
    traffic = json.loads(path.read_text())
    path.write_text(json.dumps(dict(traffic, slices=3)))
    with pytest.raises(ValueError, match="slice_seeds"):
        harness.load_cell("brest.topk", base)


def _stub_run(name, launches):
    """A run of one traced job on slice 0 of the tiny cell, with
    ``launches`` K7 intervals (s) in its trace."""
    cell = tiny(harness.load_cell(name))
    sl = generator.make_slice(cell.config, 0)
    summary = trace.Summary(window_s=1.0, busy_s=1.0, gaps=[],
                            kernels={"stjoin_sim_panel_fused_kernel":
                                     launches} if launches else {})
    job = harness.Job(slice=0, start=0.0, end=1.0, due=0.0)
    return SimpleNamespace(cell=cell, traced=[job, job], trace=summary,
                           slices=[sl], work={0: (5000, 900)},
                           jobs=[job, job])


def test_k7_roofline_reads_top_k_jobs_only():
    read = harness.metric_readers()["stjoin_sim_panel_topk_roofline"].read
    launches = [(0.0, 2e-4), (3e-4, 5e-4), (6e-4, 7e-4)]
    run = _stub_run("brest.topk", launches)
    T, M = run.slices[0].shape
    one = roofline.sim_panel_topk(T, M, 5000, 900)
    got = read(run)
    assert got == pytest.approx(100.0 * 2 * one / 5e-4)
    assert 0.0 < got < 100.0
    assert read(_stub_run("brest.topk", [])) is None
    assert read(_stub_run("brest.dense", launches)) is None
    dense_k4 = harness.metric_readers()["stjoin_sim_fused_roofline"].read
    assert dense_k4(run) is None
