"""The frozen generator against the port's, and the reference against
``run_dsc`` on the CPU (plain versions) at a tiny size."""
import numpy as np
import pytest
import torch

from conftest import SEED, tiny

from dscbench import generator, harness
from dscbench.reference import compare, pipeline


def test_generator_is_the_launchers():
    from repro_torch.data.synthetic import ais_like, default_dsc_params_for
    cell = harness.load_cell("brest.dense")
    cfg = tiny(cell, n_trajs=80, max_points=128).config
    sl = generator.make_slice(cfg, SEED)
    b, _ = ais_like(n_vessels=80, n_lanes=8, max_points=128, seed=SEED,
                    device="cpu")
    for mine, theirs in zip((sl.x, sl.y, sl.t, sl.valid, sl.traj_id),
                            (b.x, b.y, b.t, b.valid, b.traj_id)):
        assert np.array_equal(mine, theirs.numpy())
    diam, mean_dt = default_dsc_params_for(b)
    assert sl.params["eps_sp"] == 0.15 * diam
    assert sl.params["eps_t"] == 1.0 * mean_dt


@pytest.mark.parametrize("name", ["brest.dense", "brest.topk"])
def test_reference_agrees_with_run_dsc(tiny_cell, name):
    cell = tiny_cell(name)
    sl = generator.make_slice(cell.config, SEED)
    prog = harness.Program(cell, torch.device("cpu"))
    host, params = prog.host(sl)
    labels, out, _ = prog.job(host, params, timed=False)
    arrays = [torch.from_numpy(a) for a in
              (sl.x, sl.y, sl.t, sl.valid, sl.traj_id)]
    ref = pipeline.run(arrays, sl.params)
    vals = compare.readings(out, ref, cell.plan["sim_mode"],
                            cell.plan.get("sim_topk") or 32)
    vals["labels"] = compare.label_gaps(labels, ref)
    assert all(v == 0 for v in vals.values()), vals
    ok, checks = compare.verdict(vals, cell.spec["checks"])
    assert ok and list(checks) == list(cell.spec["checks"])
    assert 0 < ref.n_best <= ref.n_pairs


def test_window_join_is_the_all_pairs_join(tiny_cell):
    """The binary-searched window against every pair (the plain twin of
    the join kernel, frozen here in a few lines)."""
    cell = tiny_cell("brest.dense")
    sl = generator.make_slice(cell.config, SEED + 1)
    x, y, t, v, ids = (torch.from_numpy(a) for a in
                       (sl.x, sl.y, sl.t, sl.valid, sl.traj_id))
    eps = torch.tensor(sl.params["eps_sp"], dtype=torch.float32)
    et = torch.tensor(sl.params["eps_t"], dtype=torch.float32)
    dx = x.reshape(-1, 1, 1) - x[None]
    dy = y.reshape(-1, 1, 1) - y[None]
    dt = (t.reshape(-1, 1, 1) - t[None]).abs()
    d2 = dx * dx + dy * dy
    ok = ((d2 <= eps * eps) & (dt <= et) & v.reshape(-1, 1, 1) & v[None]
          & (ids.repeat_interleave(t.shape[1])[:, None, None]
             != ids[None, :, None]))
    w = torch.where(ok, 1.0 - torch.sqrt(d2.double()).float() / eps, -1.0)
    bw, bq = w.max(dim=-1)
    p, c = torch.nonzero(bw > 0, as_tuple=True)
    blocks = list(pipeline.join_blocks(x, y, t, v, ids, sl.params["eps_sp"],
                                       sl.params["eps_t"]))
    got = [torch.cat(z) for z in zip(*[b[:4] for b in blocks])]
    assert torch.equal(got[0], p) and torch.equal(got[1], c)
    assert torch.equal(got[2], bq[p, c]) and torch.equal(got[3], bw[p, c])
    assert sum(b[4] for b in blocks) == int(ok.sum())
