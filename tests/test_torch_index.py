"""PyTorch port: the spatiotemporal index and the index-pruned join held
against the JAX package.

* ``repro_torch.index.grid`` against ``repro.index.grid`` on the same
  numpy inputs: boxes, grid specs, cell tables, the coarse and exact
  masks and the compacted lists equal, on random data, on points exactly
  on eps and cell edges, and on all-invalid tiles.
* The plans (``plan_join_index``, ``plan_fused_tiles``): tile ids and
  counts equal to the reference's at its default geometry and at the
  port's, on data that really prunes (``0 < kept < dense``).
* The plain pruned passes (K10-K13's plain versions) bit for bit the
  port's dense plain passes, and against the reference's pruned Pallas
  kernels in interpret mode under the dense tests' tolerances: K1 weights
  to one ulp (``PALLAS_K1_ATOL``, XLA's FMA), vote and raw to 1e-5 (the
  reference sums in another order), words and indices equal.
* ``run_dsc(use_index=True)`` in every mode: labels, ``sub_local``, final
  K and ``sim_overflow`` equal to ``repro.core.dsc.run_dsc``'s.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dsc as jdsc
from repro.core import geometry as jgeo
from repro.core.types import DSCParams as JParams
from repro.core.types import TrajectoryBatch as JB
from repro.data import synthetic as jsyn
from repro.index import grid as jgrid
from repro.kernels.stjoin import ops as jops
from repro_torch.core import dsc as tdsc
from repro_torch.core import geometry as tgeo
from repro_torch.core.plan import EnginePlan
from repro_torch.core.types import DSCParams, TrajectoryBatch
from repro_torch.index import grid as tgrid
from repro_torch.kernels.stjoin import ops as tops

torch.set_num_threads(1)

FIELDS = ("x", "y", "t", "valid", "traj_id")
BOX_FIELDS = ("xmin", "xmax", "ymin", "ymax", "tmin", "tmax", "nonempty")
TABLE_FIELDS = ("order", "starts", "cell_of", "coords")
LABELS = ("member_of", "is_rep", "is_outlier")
# see tests/test_torch_join.py: XLA contracts the interpreted Pallas
# join's d2 into an FMA, so single weights may sit one ulp of 1.0 apart
PALLAS_K1_ATOL = 2.4e-7
ATOL = 1e-5
# the reference's default geometries: the join (bp, bc) and the fused
# passes (rows = 2048 // M, bc)
JAX_JOIN = dict(bp=256, bc=8)
JAX_FUSED_BC = 16


def _port(jb) -> TrajectoryBatch:
    return TrajectoryBatch.from_arrays(
        *(np.asarray(getattr(jb, f)) for f in FIELDS), device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rand(rng, T, M, *, invalid_rows=(), scale=10.0, shift=0.0):
    """``tests/test_index.py``'s random batch: time-sorted rows, 15%
    invalid points."""
    x = (rng.uniform(0, scale, (T, M)) + shift).astype(np.float32)
    y = (rng.uniform(0, scale, (T, M)) + shift).astype(np.float32)
    t = np.sort(rng.uniform(0, 50, (T, M)), axis=1).astype(np.float32)
    v = rng.uniform(0, 1, (T, M)) > 0.15
    for r in invalid_rows:
        v[r] = False
    return x, y, t, v


def _jb(x, y, t, v, ids=None):
    ids = np.arange(x.shape[0], dtype=np.int32) if ids is None else ids
    return JB(x=jnp.asarray(x), y=jnp.asarray(y), t=jnp.asarray(t),
              valid=jnp.asarray(v), traj_id=jnp.asarray(ids))


def _edge_batch():
    """``tests/test_index.py::test_pruned_join_edge_cells``: row 1 lies
    exactly eps_sp = 2 away from row 0, every point on a cell edge."""
    T, M = 2, 16
    x = np.zeros((T, M), np.float32)
    x[1] = 2.0
    t = np.tile(np.arange(M, dtype=np.float32), (T, 1))
    return x, np.zeros((T, M), np.float32), t, np.ones((T, M), bool)


def _two_clusters(n=64, M=16, seed=9):
    """Two clusters 100 apart in space (``test_index.py:160-177``), ``n //
    2`` rows each, so whole 32-candidate tiles of one never meet the
    other."""
    rng = np.random.default_rng(seed)
    near = _rand(rng, n // 2, M, scale=1.0)
    far = _rand(rng, n // 2, M, scale=1.0, shift=100.0)
    return _jb(*(np.concatenate([a, b]) for a, b in zip(near, far)))


def _lane_sorted(n=128, M=16):
    """Lane-clustered AIS traffic with rows stably sorted by lane
    (``benchmarks/kernel_bench.py:44-56``); prune with eps (3.0, 600)."""
    jb, lanes = jsyn.ais_like(n_vessels=n, n_lanes=8, max_points=M,
                              area=100.0, lane_width=0.5, seed=1)
    o = np.argsort(lanes, kind="stable")
    return JB(x=jb.x[o], y=jb.y[o], t=jb.t[o], valid=jb.valid[o],
              traj_id=jb.traj_id[o])


PRUNE_CASES = {"clusters": (_two_clusters, (2.0, 10.0)),
               "lanes": (_lane_sorted, (3.0, 600.0))}


def _prune_case(name, **size):
    make, eps = PRUNE_CASES[name]
    jb = make(**size)
    return jb, _port(jb), eps


# ---------------------------------------------------------------------------
# grid structures
# ---------------------------------------------------------------------------


def _grid_inputs(case):
    rng = np.random.default_rng(2)
    if case == "random":
        ref, cand, eps, bp, bc = _rand(rng, 8, 32), _rand(rng, 8, 32), \
            (2.0, 10.0), 32, 2
    elif case == "edge":
        ref = cand = _edge_batch()
        eps, bp, bc = (2.0, 1.0), 16, 1
    elif case == "invalid":
        ref = _rand(rng, 8, 16, invalid_rows=(1, 2, 5))
        cand = _rand(rng, 8, 16, invalid_rows=(0, 3))
        eps, bp, bc = (2.0, 10.0), 16, 2
    elif case == "all_invalid":
        ref = _rand(rng, 4, 16, invalid_rows=range(4))
        cand = _rand(rng, 4, 16, invalid_rows=range(4))
        eps, bp, bc = (2.0, 10.0), 16, 2
    else:                               # "coarse": cells coarsened
        ref, cand = _rand(rng, 8, 32), _rand(rng, 8, 32)
        eps, bp, bc = (0.05, 0.2), 32, 2
    return ref, cand, eps, bp, bc


@pytest.mark.parametrize("case", ["random", "edge", "invalid",
                                  "all_invalid", "coarse"])
def test_grid_structures_match_reference(case):
    """Boxes, grid spec, CSR cell table (``order``, ``starts``,
    ``coords``), coarse / exact / candidate masks, compacted lists and
    the row-level mask equal to ``repro.index.grid``'s."""
    ref, cand, eps, bp, bc = _grid_inputs(case)
    flat = lambda a: a.reshape(-1)
    jr = jgrid.point_block_boxes(*(jnp.asarray(flat(a)) for a in ref), bp)
    tr = tgrid.point_block_boxes(*(torch.from_numpy(flat(a)) for a in ref),
                                 bp)
    jc = jgrid.traj_block_boxes(*(jnp.asarray(a) for a in cand), bc)
    tc = tgrid.traj_block_boxes(*(torch.from_numpy(a) for a in cand), bc)
    for f in BOX_FIELDS:
        assert np.array_equal(_np(getattr(jr, f)), _np(getattr(tr, f))), f
        assert np.array_equal(_np(getattr(jc, f)), _np(getattr(tc, f))), f
    js, ts = jgrid.fit_grid(jc, *eps), tgrid.fit_grid(tc, *eps)
    assert js.__dict__ == ts.__dict__ and ts.num_cells == js.num_cells
    jt, tt = jgrid.build_cell_table(js, jc), tgrid.build_cell_table(ts, tc)
    for f in TABLE_FIELDS:
        assert np.array_equal(_np(getattr(jt, f)), _np(getattr(tt, f))), f
        assert getattr(tt, f).dtype == torch.int32
    masks = {}
    for name, args_j, args_t in (
            ("coarse", (js, jt, jr, jc), (ts, tt, tr, tc)),
            ("exact", (jr, jc), (tr, tc)),
            ("candidate", (js, jt, jr, jc), (ts, tt, tr, tc))):
        jm = getattr(jgrid, f"{name}_pair_mask" if name != "candidate"
                     else "candidate_tile_mask")(*args_j, *eps)
        tm = getattr(tgrid, f"{name}_pair_mask" if name != "candidate"
                     else "candidate_tile_mask")(*args_t, *eps)
        assert np.array_equal(_np(jm), _np(tm)), name
        masks[name] = tm
    assert bool((masks["coarse"] | ~masks["exact"]).all())   # exact => coarse
    for k in sorted({1, min(3, tc.num_tiles), tc.num_tiles}):
        ji, jn = jgrid.compact_candidates(jnp.asarray(_np(masks["exact"])), k)
        ti, tn = tgrid.compact_candidates(masks["exact"], k)
        assert np.array_equal(_np(ji), _np(ti)) and ti.dtype == torch.int32
        assert np.array_equal(_np(jn), _np(tn))
    jrow = jgrid.trajectory_pair_mask(*(jnp.asarray(a) for a in ref),
                                      *(jnp.asarray(a) for a in cand), *eps)
    trow = tgrid.trajectory_pair_mask(*(torch.from_numpy(a) for a in ref),
                                      *(torch.from_numpy(a) for a in cand),
                                      *eps)
    assert np.array_equal(_np(jrow), _np(trow))
    st = tgrid.prune_stats(masks["exact"].sum(1).to(torch.int32),
                           tc.num_tiles)
    assert int(st.kept_tiles) == int(masks["exact"].sum())
    assert st.dense_tiles == tr.num_tiles * tc.num_tiles
    if case == "all_invalid":
        assert not bool(masks["candidate"].any())
    if case == "coarse":
        assert max(ts.nx, ts.ny, ts.nt) == 64


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geometry", ["reference", "port"])
@pytest.mark.parametrize("case", sorted(PRUNE_CASES))
def test_plans_match_reference(case, geometry):
    """``tile_ids`` and counts of both plans equal to the reference's, at
    its default geometry and at the port's; the data prunes at both (the
    reference's fused blocks hold 2048 // M = 128 rows, so the batches
    are larger here than in the sweeps below)."""
    jb, tb, eps = _prune_case(case, n=256 if case == "clusters" else 512)
    M = tb.x.shape[1]
    jkw = JAX_JOIN if geometry == "reference" else dict(
        bp=tops.JOIN_BP, bc=tops.JOIN_BC)
    jm, jn, jspec = jops.plan_join_index(jb, jb, *eps, **jkw)
    tm, tn, tspec = tops.plan_join_index(tb, tb, *eps, **jkw)
    assert np.array_equal(_np(jm), _np(tm)) and np.array_equal(_np(jn),
                                                               _np(tn))
    assert jspec.__dict__ == tspec.__dict__
    assert 0 < int(tm.sum()) < tm.numel()
    fkw = (dict(rows=2048 // M, bc=JAX_FUSED_BC) if geometry == "reference"
           else dict(rows=tops.FUSED_ROWS, bc=tops.FUSED_BC))
    arrays = lambda b: (b.x, b.y, b.t, b.valid) * 2
    jp = jops.plan_fused_tiles(*arrays(jb), *eps, **fkw)
    tp = tops.plan_fused_tiles(*arrays(tb), *eps, **fkw)
    assert (tp.rows, tp.bc) == (jp.rows, jp.bc)
    assert np.array_equal(_np(jp.tile_ids), _np(tp.tile_ids))
    kept = int((tp.tile_ids >= 0).sum())
    n_tiles = -(-tb.num_trajs // 32) * 32 // tp.bc
    assert 0 < kept < tp.tile_ids.shape[0] * n_tiles
    # the port's own plan's transposed entries are its row-major ones
    pairs, blocks = tp.by_row
    tpairs, tiles = tp.by_tile
    assert pairs.shape == (kept, 2) and np.all(np.diff(blocks) >= 0)
    assert np.all(np.diff(tiles) >= 0)
    assert sorted(map(tuple, pairs.tolist())) == sorted(
        map(tuple, tpairs.tolist()))


def test_max_tiles_too_small_raises():
    jb, tb, eps = _prune_case("lanes")
    with pytest.raises(ValueError, match="max_tiles"):
        tops.best_match_join_pruned(tb, tb, *eps, max_tiles=1)
    with pytest.raises(ValueError, match="max_tiles"):
        tops.plan_fused_tiles(tb.x, tb.y, tb.t, tb.valid, tb.x, tb.y, tb.t,
                              tb.valid, *eps, max_tiles=1)
    # a wide enough K pads with -1 and changes nothing
    wide = tops.best_match_join_pruned(tb, tb, *eps, max_tiles=5)
    dense = tops.best_match_join_kernel(tb, tb, *eps)
    assert torch.equal(wide.best_w, dense.best_w)


def test_kernels_reject_plans_of_another_geometry():
    """The pruned kernels read only the port's geometry; a plan of another
    one is refused before launch, naming both (the plain versions take
    any geometry)."""
    _, tb, eps = _prune_case("lanes")
    arrays = (tb.x, tb.y, tb.t, tb.valid) * 2
    plan = tops.plan_fused_tiles(*arrays, *eps, rows=2, bc=16)
    T, C = tb.num_trajs, tb.num_trajs
    with pytest.raises(ValueError, match=r"rows=2, bc=16.*rows=1, bc=32"):
        tops._resolve_plan(plan, "stjoin_vote_fused_pruned", True, T, C,
                           tb.device)
    assert tops._resolve_plan(plan, "x", False, T, C, tb.device) is plan
    own = tops.plan_fused_tiles(*arrays, *eps)
    tops._resolve_plan(own, "x", True, T, C, tb.device)
    with pytest.raises(ValueError, match=r"expected \[5, K >= 1\]"):
        tops._resolve_plan(own, "x", True, 5, C, tb.device)
    with pytest.raises(ValueError, match=r"bp=256, bc=8.*bp=64, bc=32"):
        tops._check_join_geometry("stjoin_best_match_pruned", 256, 8)
    tops._check_join_geometry("stjoin_best_match_pruned", 64, 32)


# ---------------------------------------------------------------------------
# the pruned passes
# ---------------------------------------------------------------------------


def _arrays(b):
    return tuple(getattr(b, f) for f in FIELDS)


def _cross():
    """A cross join: 40 reference rows of one batch against 70 candidate
    rows of another, lane-sorted, other M and Mc."""
    ref = _lane_sorted(40, 12)
    cand = _lane_sorted(70, 16)
    return ref, cand


@pytest.mark.parametrize("case", ["clusters", "lanes"])
def test_pruned_join_bitwise_dense_and_reference(case):
    """K10's plain version (via ``best_match_join_pruned``) at the port's
    geometry and at the reference's: bitwise the dense plain join; and the
    reference's pruned Pallas join to one ulp, indices equal."""
    jb, tb, eps = _prune_case(case)
    dense = tops.best_match_join_kernel(tb, tb, *eps)
    for kw in ({}, JAX_JOIN):
        out, st = tops.best_match_join_pruned(tb, tb, *eps,
                                              return_stats=True, **kw)
        assert torch.equal(out.best_w, dense.best_w)
        assert torch.equal(out.best_idx, dense.best_idx)
        assert 0 < int(st.kept_tiles) < st.dense_tiles
    jout = jops.best_match_join_pruned(jb, jb, *eps, **JAX_JOIN)
    assert np.array_equal(_np(jout.best_idx), _np(out.best_idx))
    np.testing.assert_allclose(_np(out.best_w), _np(jout.best_w), rtol=0,
                               atol=PALLAS_K1_ATOL)
    assert bool((dense.best_idx >= 0).any())


@pytest.mark.parametrize("delta_t", [0.0, 300.0])
def test_index_join_with_refine(delta_t):
    """``subtrajectory_join(use_index=True)``: the kernel-backed join
    (K10 then the refine) and the plain join under the row-level mask,
    each equal to its reference's and to its own dense join."""
    jb, tb, eps = _prune_case("lanes")
    for jfun, tfun, atol in ((jops.subtrajectory_join,
                              tops.subtrajectory_join, PALLAS_K1_ATOL),
                             (jgeo.subtrajectory_join,
                              tgeo.subtrajectory_join, 0.0)):
        j = jfun(jb, jb, *eps, delta_t, use_index=True)
        t = tfun(tb, tb, *eps, delta_t, use_index=True)
        d = tfun(tb, tb, *eps, delta_t)
        assert torch.equal(t.best_w, d.best_w)
        assert torch.equal(t.best_idx, d.best_idx)
        assert np.array_equal(_np(j.best_idx), _np(t.best_idx))
        np.testing.assert_allclose(_np(t.best_w), _np(j.best_w), rtol=0,
                                   atol=atol)
    mask = tgrid.trajectory_pair_mask(tb.x, tb.y, tb.t, tb.valid, tb.x,
                                      tb.y, tb.t, tb.valid, *eps)
    assert 0 < int(mask.sum()) < mask.numel()


def _fused_inputs(name):
    if name == "cross":
        jr, jc = _cross()
        eps = (3.0, 600.0)
    else:
        jr, _, eps = _prune_case(name)
        jc = jr
    return jr, jc, _port(jr), _port(jc), eps


def _plans(jr, jc, tr, tc, eps):
    """The port's plan at its own geometry, and the reference's plan at
    its default geometry (as a port plan, for the plain versions)."""
    arrays = lambda r, c: (r.x, r.y, r.t, r.valid, c.x, c.y, c.t, c.valid)
    own = tops.plan_fused_tiles(*arrays(tr, tc), *eps)
    M = tr.x.shape[1]
    jp = jops.plan_fused_tiles(*arrays(jr, jc), *eps, rows=2048 // M,
                               bc=JAX_FUSED_BC)
    ref = tops.FusedTilePlan(torch.from_numpy(np.array(jp.tile_ids)),
                             jp.rows, jp.bc)
    return own, ref, jp


@pytest.mark.parametrize("name,delta_t,with_masks", [
    ("clusters", 0.0, True), ("lanes", 300.0, True), ("lanes", 0.0, False),
    ("cross", 200.0, True)])
def test_pruned_vote_pass(name, delta_t, with_masks):
    """K11's plain version: vote and words bitwise the dense plain pass
    under both plans; against the reference's pruned pass (its plan, and
    the port's plan at the port's geometry): words equal, vote to 1e-5."""
    jr, jc, tr, tc, eps = _fused_inputs(name)
    own, ref, jp = _plans(jr, jc, tr, tc, eps)
    args = (*_arrays(tr), *_arrays(tc), *eps, delta_t)
    dv, dw = tops.stjoin_vote_fused_arrays(*args, with_masks=with_masks)
    for plan in (own, ref):
        v, w = tops.stjoin_vote_fused_arrays(*args, tile_ids=plan,
                                             with_masks=with_masks)
        assert torch.equal(v, dv)
        assert (w is None and dw is None) or torch.equal(w, dw)
    jargs = (*_arrays(jr), *_arrays(jc), *eps, delta_t)
    for jkw in (dict(tile_ids=jp), dict(
            tile_ids=jnp.asarray(own.tile_ids.numpy()), rows=1, bc=32)):
        jv, jw = jops.stjoin_vote_fused_arrays(*jargs, with_masks=with_masks,
                                               **jkw)
        np.testing.assert_allclose(_np(v), _np(jv), rtol=0, atol=ATOL)
        if with_masks:
            assert np.array_equal(_np(w).view(np.uint32), _np(jw))
    assert bool((dv > 0).any())
    # batch level: use_index plans and sweeps, with the same result
    if name != "cross":
        bv, bw = tops.stjoin_vote_fused(tr, tc, *eps, delta_t, use_index=True,
                                        with_masks=with_masks)
        assert torch.equal(bv, dv)


def _slots(rng, tr, tc, ms):
    rsub = rng.integers(-1, ms, tr.x.shape).astype(np.int32)
    csub = rng.integers(-1, ms, tc.x.shape).astype(np.int32)
    return rsub, csub


@pytest.mark.parametrize("name,delta_t", [("clusters", 0.0),
                                          ("lanes", 300.0),
                                          ("cross", 0.0)])
def test_pruned_sim_passes(name, delta_t):
    """K12's and K13's plain versions: ``raw`` and every panel's two
    slabs bitwise the dense plain passes under both plans (panels of 12
    split trajectories' slots); ``raw`` to 1e-5 of the reference's pruned
    pass."""
    jr, jc, tr, tc, eps = _fused_inputs(name)
    own, ref, jp = _plans(jr, jc, tr, tc, eps)
    ms = 3
    rsub, csub = _slots(np.random.default_rng(5), tr, tc, ms)
    rs, cs = torch.from_numpy(rsub), torch.from_numpy(csub)
    args = (tr, tc, rs, cs, ms, *eps, delta_t)
    draw = tops.stjoin_sim_fused(*args)
    for plan in (own, ref):
        assert torch.equal(tops.stjoin_sim_fused(*args, tile_ids=plan), draw)
    S = min(tr.num_trajs, tc.num_trajs) * ms
    for p0 in range(0, S - 12 + 1, 36):
        dense = tops.stjoin_sim_panel_fused(*args, p0=p0, panel=12)
        for plan in (own, ref):
            got = tops.stjoin_sim_panel_fused(*args, p0=p0, panel=12,
                                              tile_ids=plan)
            assert torch.equal(got[0], dense[0]) and torch.equal(got[1],
                                                                 dense[1])
        assert torch.equal(dense[0], draw[p0:p0 + 12])
    jraw = jops.stjoin_sim_fused(jr, jc, rsub, csub, ms, *eps, delta_t,
                                 tile_ids=jp)
    np.testing.assert_allclose(draw.numpy(), _np(jraw), rtol=0, atol=ATOL)
    assert bool((draw > 0).any())


# ---------------------------------------------------------------------------
# run_dsc end to end
# ---------------------------------------------------------------------------

FIG1 = dict(eps_sp=0.42, eps_t=1.0, delta_t=0.0, w=6, tau=0.15,
            alpha_sigma=-1.0, k_sigma=-1.0, segmentation="tsa2")
KERNELS = dict(use_kernel=True, seg_use_kernel=True, cluster_use_kernel=True)
MODES = {"materialize_plain": dict(),
         "materialize_kernel": dict(KERNELS),
         "fused": dict(KERNELS, mode="fused"),
         "fused_topk": dict(KERNELS, mode="fused", sim_mode="topk")}


def _dsc_case(name):
    if name == "fig1":
        return jsyn.figure1_scenario(n_per_route=4, points_per_leg=24,
                                     seed=0)[0], FIG1
    jb = _lane_sorted(128, 16)
    return jb, dict(eps_sp=3.0, eps_t=600.0, delta_t=0.0, w=4, tau=0.4,
                    alpha_sigma=-1.0, k_sigma=-1.0, segmentation="tsa2")


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", ["fig1", "lanes"])
def test_run_dsc_use_index_matches_reference(case, mode):
    """Labels, ``sub_local``, final K and ``sim_overflow`` equal to the
    reference's ``run_dsc(use_index=True)``; labels equal to the port's
    own unpruned run."""
    jb, kw = _dsc_case(case)
    flags = MODES[mode]
    jo = jdsc.run_dsc(jb, JParams(**kw), use_index=True, **flags)
    tb, p = _port(jb), DSCParams(**kw)
    to = tdsc.run_dsc(tb, p, device="cpu",
                      plan=EnginePlan(use_index=True, **flags))
    dense = tdsc.run_dsc(tb, p, device="cpu", plan=EnginePlan(**flags))
    for f in LABELS:
        assert np.array_equal(_np(getattr(jo.result, f)),
                              _np(getattr(to.result, f))), f
        assert torch.equal(getattr(to.result, f), getattr(dense.result, f))
    assert np.array_equal(_np(jo.seg.sub_local), _np(to.seg.sub_local))
    if mode == "fused_topk":
        assert to.sim_topk.k == jo.sim_topk.k
        assert int(to.sim_overflow) == int(jo.sim_overflow) == 0
    else:
        assert to.sim_overflow is None and jo.sim_overflow is None
        assert torch.equal(to.sim, dense.sim)
    assert int(to.result.is_rep.sum()) >= 1


def _scenario_batch(name):
    """fig1 or ``ais_like`` at the sizes of ``tests/test_torch_dsc.py``,
    with that file's eps."""
    if name == "fig1":
        jb = jsyn.figure1_scenario(n_per_route=4, points_per_leg=24,
                                   seed=0)[0]
        return jb, _port(jb), (0.42, 1.0)
    jb = jsyn.ais_like(n_vessels=24, max_points=96, seed=1)[0]
    diam, mean_dt = jsyn.default_dsc_params_for(jb)
    return jb, _port(jb), (0.15 * diam, mean_dt)


@pytest.mark.parametrize("use_cells", [True, False])
@pytest.mark.parametrize("case", ["fig1", "ais"])
def test_use_cells_and_max_tiles_match_reference(case, use_cells):
    """``use_cells=`` of ``plan_join_index``, ``best_match_join_pruned``,
    ``plan_fused_tiles`` and ``stjoin_vote_fused``, and ``max_tiles=`` of
    ``stjoin_vote_fused``: masks, counts and kept tiles equal to the
    reference's at its geometry (``use_cells=False`` is the exact box
    test alone, with no grid spec); the join and the vote pass equal to
    the reference's and bitwise the port's unpruned ones; a ``max_tiles``
    that drops a tile is refused by both."""
    jb, tb, eps = _scenario_batch(case)
    jm, jn, jspec = jops.plan_join_index(jb, jb, *eps, use_cells=use_cells,
                                         **JAX_JOIN)
    tm, tn, tspec = tops.plan_join_index(tb, tb, *eps, use_cells=use_cells,
                                         **JAX_JOIN)
    assert np.array_equal(_np(jm), _np(tm)) and np.array_equal(_np(jn),
                                                               _np(tn))
    if use_cells:
        assert jspec.__dict__ == tspec.__dict__
    else:
        assert jspec is None and tspec is None
    jout = jops.best_match_join_pruned(jb, jb, *eps, use_cells=use_cells,
                                       **JAX_JOIN)
    tout = tops.best_match_join_pruned(tb, tb, *eps, use_cells=use_cells)
    dense = tops.best_match_join_kernel(tb, tb, *eps)
    assert torch.equal(tout.best_w, dense.best_w)
    assert torch.equal(tout.best_idx, dense.best_idx)
    assert np.array_equal(_np(jout.best_idx), _np(tout.best_idx))
    np.testing.assert_allclose(_np(tout.best_w), _np(jout.best_w), rtol=0,
                               atol=PALLAS_K1_ATOL)
    M = tb.x.shape[1]
    fkw = dict(rows=2048 // M, bc=JAX_FUSED_BC)
    arrays = lambda b: (b.x, b.y, b.t, b.valid) * 2
    jp = jops.plan_fused_tiles(*arrays(jb), *eps, use_cells=use_cells,
                               **fkw)
    tp = tops.plan_fused_tiles(*arrays(tb), *eps, use_cells=use_cells,
                               **fkw)
    assert np.array_equal(_np(jp.tile_ids), _np(tp.tile_ids))
    # each at its own geometry (the reference's refuses a width past its
    # tile count, so both take their widest list)
    own = tops.plan_fused_tiles(*arrays(tb), *eps, use_cells=use_cells)
    jv, jw = jops.stjoin_vote_fused(jb, jb, *eps, use_index=True,
                                    use_cells=use_cells,
                                    max_tiles=jp.tile_ids.shape[1])
    tv, tw = tops.stjoin_vote_fused(tb, tb, *eps, use_index=True,
                                    use_cells=use_cells,
                                    max_tiles=own.tile_ids.shape[1])
    dv, dw = tops.stjoin_vote_fused(tb, tb, *eps)
    assert torch.equal(tv, dv) and torch.equal(tw, dw)
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=0, atol=ATOL)
    assert np.array_equal(_np(tw).view(np.uint32), _np(jw))
    small = jp.tile_ids.shape[1] - 1
    assert small >= 1
    with pytest.raises(ValueError, match="max_tiles"):
        jops.stjoin_vote_fused(jb, jb, *eps, use_index=True,
                               use_cells=use_cells, max_tiles=small)
    with pytest.raises(ValueError, match="max_tiles"):
        tops.plan_fused_tiles(*arrays(tb), *eps, use_cells=use_cells,
                              max_tiles=small, **fkw)
