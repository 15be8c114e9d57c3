"""The control and the faults: each has to come out as not correct.

The control is the reference computed in bfloat16, the precision below
the configuration's float32, in the program's place.  The faults break the
timed path underneath a whole run (``harness.run_cell`` on the CPU, the
look for a card skipped): a stage that leaves its state unchanged, half
of the batch left out, an answer altered where it is produced, a NaN
written where the answer is 0.  (A cell on one chip has no exchange
between chips to leave out.)"""
import time

import pytest
import torch

from conftest import SEED

from dscbench import generator, harness
from dscbench.reference import compare, pipeline


@pytest.mark.parametrize("name", ["brest.dense", "brest.topk"])
def test_control_fails(tiny_cell, name):
    cell = tiny_cell(name)
    sl = generator.make_slice(cell.config, SEED)
    arrays = [torch.from_numpy(a) for a in
              (sl.x, sl.y, sl.t, sl.valid, sl.traj_id)]
    ref = pipeline.run(arrays, sl.params)
    low = pipeline.run(arrays, sl.params, dtype=torch.bfloat16)
    k0 = cell.plan.get("sim_topk") or 32
    vals = compare.readings(
        compare.RefOutput(low, cell.plan["sim_mode"], low.topk_k(k0)), ref,
        cell.plan["sim_mode"], k0)
    vals["labels"] = compare.label_gaps(
        (low.member_of, low.is_rep, low.is_outlier), ref)
    ok, _ = compare.verdict(vals, cell.spec["checks"])
    assert not ok
    assert vals["labels"] > 0 and vals["vote"] > 1e-3
    if cell.plan["sim_mode"] == "topk":
        assert vals["topk_lists"] > 0


class Unchanged(harness.Program):
    """Clustering leaves its state as it found it: nothing resolved."""

    def run(self, batch, params, stage_times):
        out = super().run(batch, params, stage_times)
        r = out.result
        r.member_of = torch.full_like(r.member_of, -1)
        r.is_rep = torch.zeros_like(r.is_rep)
        r.is_outlier = out.table.valid.clone()
        return out


class HalfBatch(harness.Program):
    """Half of the trajectories left out; the thresholds' means are taken
    over the rest."""

    def run(self, batch, params, stage_times):
        T = batch.num_trajs
        half = self.Batch(*(a[:T // 2] for a in
                            (batch.x, batch.y, batch.t, batch.valid,
                             batch.traj_id)))
        part = super().run(half, params, stage_times)
        full = super().run(batch, params, None)
        S2 = part.result.member_of.shape[0]
        r = full.result
        r.member_of = torch.cat([part.result.member_of,
                                 torch.full_like(r.member_of[S2:], -1)])
        r.is_rep = torch.cat([part.result.is_rep,
                              torch.zeros_like(r.is_rep[S2:])])
        r.is_outlier = torch.cat([part.result.is_outlier,
                                  full.table.valid[S2:]])
        return full


class Altered(harness.Program):
    """One answer altered where it is produced: one slot's label."""

    def run(self, batch, params, stage_times):
        out = super().run(batch, params, stage_times)
        r = out.result
        s = int(torch.nonzero(~r.is_rep & (r.member_of >= 0))[0, 0])
        r.member_of = r.member_of.clone()
        r.member_of[s] = -1
        r.is_outlier = r.is_outlier.clone()
        r.is_outlier[s] = True
        return out


class NaNSim(harness.Program):
    """A NaN on the similarity matrix's diagonal, where the answer is 0:
    no threshold, cut or label moves."""

    def run(self, batch, params, stage_times):
        out = super().run(batch, params, stage_times)
        out.sim[0, 0] = float("nan")
        return out


class NaNScore(harness.Program):
    """A NaN in the TSA2 signal of a padding point, where it is 0."""

    def run(self, batch, params, stage_times):
        out = super().run(batch, params, stage_times)
        pad = torch.nonzero(~batch.valid.reshape(-1))[0, 0]
        out.seg.score.view(-1)[pad] = float("nan")
        return out


@pytest.mark.parametrize("fault", [None, Unchanged, HalfBatch, Altered,
                                   NaNSim, NaNScore])
def test_faults_come_out_not_correct(tiny_cell, fault):
    cell = tiny_cell("brest.dense")
    cell.traffic = dict(cell.traffic, slices=2)
    dev = torch.device("cpu")
    prog = (fault or harness.Program)(cell, dev)
    res, lines = harness.run_cell(cell, SEED, 0.5, False, dev,
                                  time.perf_counter(), program=prog)
    assert res["correct"] is (fault is None), res["checks"]
    assert [ln.split(":")[0] for ln in lines[-len(cell.spec["checks"]):]] == \
        [f"check {n}" for n in cell.spec["checks"]]


class NaNList(harness.Program):
    """A NaN in a padding slot's top-K list, where the value is 0: no
    threshold, cut or label moves."""

    def run(self, batch, params, stage_times):
        out = super().run(batch, params, stage_times)
        lists = out.sim_topk
        row = torch.nonzero(lists.ids[:, -1] < 0)[0, 0]
        lists.sims[row, -1] = float("nan")
        return out


@pytest.mark.parametrize("fault", [None, Unchanged, HalfBatch, Altered,
                                   NaNList, NaNScore])
def test_topk_faults_come_out_not_correct(tiny_cell, fault):
    """The same on the top-K cell: two fixed slices, two jobs in the
    window, and the seed's own slice after it."""
    cell = tiny_cell("brest.topk")
    cell.traffic = dict(cell.traffic, slices=2, slice_seeds=[0, 1],
                        loop="open", rate_per_s=4.0)
    dev = torch.device("cpu")
    prog = (fault or harness.Program)(cell, dev)
    res, _ = harness.run_cell(cell, SEED, 0.5, False, dev,
                              time.perf_counter(), program=prog)
    assert res["correct"] is (fault is None), res["checks"]
    assert res["attempted"] == 2
    assert set(res["checks"]) >= {"topk_k", "topk_lists"}


class AlteredOnce(Altered):
    """One label altered in the window's first job alone (after the
    warm-up's ``skip`` jobs), on a slice that the last job does not run."""

    def __init__(self, cell, device, skip):
        super().__init__(cell, device)
        self.calls, self.skip = 0, skip

    def run(self, batch, params, stage_times):
        self.calls += 1
        if self.calls == self.skip + 1:
            return super().run(batch, params, stage_times)
        return harness.Program.run(self, batch, params, stage_times)


def test_a_fault_on_another_slice_comes_out_not_correct(tiny_cell):
    """Four jobs at 4 a second over slices 0, 1, 0, 1: the fault lies in
    slice 0, the last job runs slice 1."""
    cell = tiny_cell("brest.dense")
    cell.traffic = dict(cell.traffic, slices=2, loop="open", rate_per_s=4.0)
    dev = torch.device("cpu")
    prog = AlteredOnce(cell, dev, skip=2)
    res, _ = harness.run_cell(cell, SEED, 1.0, False, dev,
                              time.perf_counter(), program=prog)
    assert res["attempted"] == 4 and prog.calls == 6
    assert res["correct"] is False
    assert res["checks"]["labels"]["value"] == 1
