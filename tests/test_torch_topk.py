"""PyTorch port: top-K similarity (``sim_mode="topk"``) held against the
JAX package and against the port's own dense path.

The same numpy-seeded inputs go through ``repro`` (Pallas kernels in
interpret mode) and through the port's plain versions on the CPU.
Tolerances and why:

* within the port, bitwise: the top-K lists, spill and moments of the
  panel sweep (materialize: the ordered scatter; fused: the plain panel
  pass) equal ``topk_from_dense`` of the port's dense matrix, because each
  cell adds the same weights in the same order and the row reductions are
  row-wise;
* the port's list primitives against ``repro.core.similarity`` on the same
  float rows: ids equal, sims and spill bitwise;
* the port's similarity against the JAX package's: the cell sums differ
  by ulps (ROADMAP queue 3: another summation order, XLA's FMA in the
  interpreted join), so ids may swap inside a near-tie.  Compared are the
  degree (equal), the lists scattered back to ``[S, S]``, the spill and
  the moments (1e-5 absolute);
* clustering: bools, slots and labels equal; ``best_w`` bitwise;
* end to end: labels, ``sim_overflow`` and the final K equal to the JAX
  package's run; sscr / rmse to 1e-5 relative against it, and bitwise
  against the port's dense run.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import clustering as jcl
from repro.core import dsc as jdsc
from repro.core import similarity as jsim
from repro.core.segmentation import tsa2 as jtsa2
from repro.core.types import DSCParams as JParams
from repro.core.types import SubtrajTable as JTable
from repro.core.types import TrajectoryBatch as JB
from repro.core import voting as jvoting
from repro.data import synthetic as jsyn
from repro.kernels.cluster.ops import (topk_cluster_assign as jassign,
                                       topk_cluster_round_scan as jscan)
from repro.kernels.stjoin import ops as jops
from repro_torch.core import clustering as tcl
from repro_torch.core import dsc as tdsc
from repro_torch.core import similarity as tsim
from repro_torch.core import voting as tvoting
from repro_torch.core.plan import EnginePlan
from repro_torch.core.segmentation import tsa2 as ttsa2
from repro_torch.core.types import DSCParams, SubtrajTable, TrajectoryBatch
from repro_torch.kernels.cluster.ref import (topk_claim_max_ref,
                                             topk_round_scan_ref)
from repro_torch.kernels.cluster.ops import (topk_cluster_assign,
                                             topk_cluster_round_scan)
from repro_torch.kernels.stjoin import ops as tops

torch.set_num_threads(1)

ATOL = 1e-5
BATCH = ("x", "y", "t", "valid", "traj_id")
LISTS = ("ids", "sims", "spill", "degree", "row_sum", "row_sumsq")
LABELS = ("member_of", "is_rep", "is_outlier")
FIG1 = dict(eps_sp=0.42, eps_t=1.0, delta_t=0.0, w=6, tau=0.15,
            alpha_sigma=-1.0, k_sigma=-1.0)
KERNEL_FLAGS = dict(seg_use_kernel=True, cluster_use_kernel=True)


def _port(jb):
    return TrajectoryBatch.from_arrays(
        *(np.asarray(getattr(jb, f)) for f in BATCH), device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_lists_equal(a, b, ctx=""):
    for f in LISTS:
        assert torch.equal(getattr(a, f), getattr(b, f)), (ctx, f)


# ---------------------------------------------------------------------------
# List primitives
# ---------------------------------------------------------------------------


def _tied_rows(seed, R=9, S=23):
    """Non-negative rows from four values (exact ties in every row), with
    some all-zero rows."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 4, (R, S)) / 4).astype(np.float32)
    x[rng.uniform(size=R) < 0.2] = 0.0
    return x


@pytest.mark.parametrize("k", [1, 5, 22, 23, 30])
def test_topk_reduce_rows_matches_reference(k):
    """Ties and K + 1 > S: ids equal, sims and spill bitwise."""
    x = _tied_rows(k)
    want = jsim.topk_reduce_rows(jnp.asarray(x), min(k, x.shape[1]))
    got = tsim.topk_reduce_rows(torch.from_numpy(x), min(k, x.shape[1]))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), k
    assert got[0].dtype == torch.int32


@pytest.mark.parametrize("k", [3, 40])
def test_topk_from_dense_matches_reference(k):
    rng = np.random.default_rng(k)
    S = 31
    sim = _tied_rows(k, S, S)
    sim = np.maximum(sim, sim.T)
    np.fill_diagonal(sim, 0.0)
    valid = rng.uniform(size=S) < 0.85
    card = rng.integers(1, 9, S).astype(np.int32)
    jt = JTable(t_start=jnp.zeros(S), t_end=jnp.ones(S),
                voting=jnp.ones(S), card=jnp.asarray(card),
                valid=jnp.asarray(valid),
                traj_row=jnp.arange(S, dtype=jnp.int32))
    tt = SubtrajTable(*(torch.tensor(_np(getattr(jt, f))) for f in
                        ("t_start", "t_end", "voting", "card", "valid",
                         "traj_row")))
    want = jsim.topk_from_dense(jnp.asarray(sim), jt, k)
    got = tsim.topk_from_dense(torch.from_numpy(sim), tt, k)
    assert got.k == min(k, S) and got.num_slots == S
    for f in LISTS:
        assert np.array_equal(_np(getattr(got, f)),
                              np.asarray(getattr(want, f))), f
    over = tsim.topk_overflow(got, 0.3)
    assert int(over) == int(jsim.topk_overflow(want, 0.3))
    assert over.dtype == torch.int32


def test_plan_panel_and_plan_fields():
    for S, target in ((96, None), (96, 12), (37, 8), (7, 1), (4096, 128)):
        assert tsim.plan_panel(S, target) == jsim.plan_panel(S, target)
    assert tsim.largest_divisor(36, 8) == 6
    for bad in (0, -2, 1.5):
        for name in ("sim_topk", "sim_panel"):
            with pytest.raises(ValueError, match=f"{name} must be None or "
                               "a positive int"):
                EnginePlan(**{name: bad}).validate()


# ---------------------------------------------------------------------------
# Panel streaming within the port: bitwise against the dense matrix
# ---------------------------------------------------------------------------


def _pieces():
    """A random batch of 12 trajectories with ms = 8 (S = 96), segmented
    through the port's materialize path; panels of 8, 12 (which splits
    trajectories' slots) and 96."""
    jb = jsyn.ais_like(n_vessels=12, max_points=24, n_lanes=4, seed=5)[0]
    tb = _port(jb)
    diam, mean_dt = jsyn.default_dsc_params_for(jb)
    eps_sp, eps_t, ms = 0.1 * diam, 4 * mean_dt, 8
    join = tops.subtrajectory_join(tb, tb, eps_sp, eps_t, 0.0)
    vote = tvoting.point_voting(join)
    seg = ttsa2(tvoting.neighbor_mask_packed(join), tb.valid, 4, 0.2, ms)
    table = tsim.build_subtraj_table(tb, seg, vote, ms)
    return jb, tb, join, seg, table, ms, (eps_sp, eps_t, 0.0)


@pytest.mark.parametrize("panel", [8, 12, 96])
def test_panel_stream_bitwise_dense(panel):
    """Materialize (``similarity_topk``) and fused (``topk_stream`` over the
    plain panel pass) equal ``topk_from_dense`` of the port's own dense
    matrices bit for bit, field by field; the panel pass's slabs are the
    rows and transposed columns of the plain K4 ``raw``."""
    _, tb, join, seg, table, ms, eps = _pieces()
    S = table.num_slots
    sub = seg.sub_local
    dense_m = tsim.similarity_matrix(join, seg, sub, table, ms)
    raw = tops.stjoin_sim_fused(tb, tb, sub, sub, ms, *eps)
    dense_f = tsim.finalize_sim(raw.clone(), table)
    for k in (4, S):
        want_m = tsim.topk_from_dense(dense_m, table, k)
        got_m = tsim.similarity_topk(join, seg, sub, table, ms, k=k,
                                     panel=panel)
        _assert_lists_equal(got_m, want_m, ("materialize", panel, k))

        def panel_raw(p0):
            fwd, rev = tops.stjoin_sim_panel_fused(tb, tb, sub, sub, ms,
                                                   *eps, p0=p0, panel=panel)
            assert torch.equal(fwd, raw[p0:p0 + panel])
            assert torch.equal(rev, raw.T[p0:p0 + panel])
            return fwd, rev

        got_f = tsim.topk_stream(panel_raw, table, k=k, panel=panel)
        _assert_lists_equal(got_f, tsim.topk_from_dense(dense_f, table, k),
                            ("fused", panel, k))
    assert int(tsim.topk_overflow(tsim.topk_from_dense(dense_m, table, 4),
                                  0.0)) > 0


def test_panel_pass_delta_t_and_cross_join():
    """The plain panel pass equals the plain K4 rows / columns with the
    delta_t refine on, and for a cross join with other slot maps."""
    rng = np.random.default_rng(3)
    jb = jsyn.ais_like(n_vessels=7, max_points=30, seed=2)[0]
    jc = jsyn.ais_like(n_vessels=9, max_points=30, seed=4)[0]
    tb, tc = _port(jb), _port(jc)
    ms = 3
    rsub = torch.from_numpy(rng.integers(-1, ms, (7, 30)).astype(np.int32))
    csub = torch.from_numpy(rng.integers(-1, ms, (9, 30)).astype(np.int32))
    eps = (15.0, 600.0, 300.0)
    raw = tops.stjoin_sim_fused(tb, tc, rsub, csub, ms, *eps)
    for p0, panel in ((0, 5), (5, 9), (19, 2)):
        fwd, rev = tops.stjoin_sim_panel_fused(tb, tc, rsub, csub, ms, *eps,
                                               p0=p0, panel=panel)
        assert torch.equal(fwd, raw[p0:p0 + panel])
        assert torch.equal(rev, raw.T[p0:p0 + panel])
    assert bool((raw > 0).any())
    with pytest.raises(ValueError, match="outside"):
        tops.stjoin_sim_panel_fused(tb, tc, rsub, csub, ms, *eps, p0=20,
                                    panel=2)
    plan = tops.plan_fused_tiles(tb.x, tb.y, tb.t, tb.valid, tc.x, tc.y,
                                 tc.t, tc.valid, *eps[:2])
    fwd, rev = tops.stjoin_sim_panel_fused(tb, tc, rsub, csub, ms, *eps,
                                           p0=5, panel=9, tile_ids=plan)
    assert torch.equal(fwd, raw[5:14]) and torch.equal(rev, raw.T[5:14])


# ---------------------------------------------------------------------------
# Against the JAX package's similarity
# ---------------------------------------------------------------------------


def _scatter_back(topk, S):
    dense = np.zeros((S, S), np.float32)
    ids, sims = _np(topk.ids), _np(topk.sims)
    r, c = np.nonzero(ids >= 0)
    dense[r, ids[r, c]] = sims[r, c]
    return dense


def _close_lists(got, want, S):
    assert np.array_equal(_np(got.degree), np.asarray(want.degree))
    np.testing.assert_allclose(_scatter_back(got, S),
                               _scatter_back(want, S), rtol=0, atol=ATOL)
    for f in ("spill", "row_sum", "row_sumsq"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=ATOL)


def test_topk_similarity_matches_reference():
    """``similarity_topk`` (materialize) and the fused panel stream against
    the JAX package's, on the same segmentation (asserted equal)."""
    jb, tb, join, seg, table, ms, eps = _pieces()
    S = table.num_slots
    jjoin = jops.subtrajectory_join(jb, jb, *eps)
    jseg = jtsa2(jvoting.neighbor_mask_packed(jjoin), jb.valid, 4, 0.2, ms)
    assert np.array_equal(np.asarray(jseg.sub_local), seg.sub_local.numpy())
    jtable = jsim.build_subtraj_table(jb, jseg, jvoting.point_voting(jjoin),
                                      ms)
    k, panel = 6, 12
    want = jsim.similarity_topk(jjoin, jseg, jseg.sub_local, jtable, ms, k=k,
                                panel=panel)
    got = tsim.similarity_topk(join, seg, seg.sub_local, table, ms, k=k,
                               panel=panel)
    _close_lists(got, want, S)

    def jpanel(p0):
        return jops.stjoin_sim_panel_fused(
            jb, jb, jseg.sub_local, jseg.sub_local, ms, *eps, p0=p0,
            panel=panel, rows=2, bc=4, bm=8)

    def tpanel(p0):
        return tops.stjoin_sim_panel_fused(
            tb, tb, seg.sub_local, seg.sub_local, ms, *eps, p0=p0,
            panel=panel)

    for p0 in (36,):           # slots 36..47 split trajectory 4's
        for a, b in zip(tpanel(p0), jpanel(p0)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=ATOL)
    _close_lists(tsim.topk_stream(tpanel, table, k=k, panel=panel),
                 jsim.topk_stream(jpanel, jtable, k=k, panel=panel), S)


def test_scatter_operands_match_reference():
    """The flat contribution list equals the reference's entry for entry
    on the same join and segmentation (the port's, handed to both)."""
    from repro.core.types import JoinResult as JJoin
    from repro.core.types import SubtrajSegmentation as JSeg
    _, _, join, seg, table, ms, _ = _pieces()
    S = table.num_slots
    jjoin = JJoin(best_w=jnp.asarray(join.best_w.numpy()),
                  best_idx=jnp.asarray(join.best_idx.numpy()))
    jseg = JSeg(*(jnp.asarray(getattr(seg, f).numpy())
                  for f in ("cut", "sub_local", "num_subs", "score")))
    got = tsim.scatter_operands(join, seg, seg.sub_local, S, ms)
    want = jsim.scatter_operands(jjoin, jseg, jseg.sub_local, S, ms)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)
    assert int((got[0] < S).sum()) > 0 and int((got[1] < S).sum()) > 0


@pytest.mark.parametrize("panel", [8, 12, 96])
def test_contribution_panel_raw_list_contract(panel):
    """Top-K over the public ``contribution_panel_raw`` (the flat list of
    ``scatter_operands``, the reference's contract) gives the port's
    ``similarity_topk`` bit for bit, its slabs are the dense ``raw``'s
    rows and transposed columns, and it agrees with the reference's
    closure over the reference's own list to the stated tolerance."""
    jb, _, join, seg, table, ms, eps = _pieces()
    S = table.num_slots
    ops = tsim.scatter_operands(join, seg, seg.sub_local, S, ms)
    fn = tsim.contribution_panel_raw(*ops, S, panel)
    raw = tsim.scatter_raw(join.best_w, join.best_idx,
                           tsim.slot_ids(seg.sub_local, ms, S),
                           tsim.slot_ids(seg.sub_local, ms, S), S, S)
    for p0 in range(0, S, panel):
        fwd, rev = fn(p0)
        assert torch.equal(fwd, raw[p0:p0 + panel])
        assert torch.equal(rev, raw.T[p0:p0 + panel])
    for k in (4, S):
        got = tsim.topk_stream(fn, table, k=k, panel=panel)
        _assert_lists_equal(got, tsim.similarity_topk(
            join, seg, seg.sub_local, table, ms, k=k, panel=panel),
            (panel, k))
    jjoin = jops.subtrajectory_join(jb, jb, *eps)
    jseg = jtsa2(jvoting.neighbor_mask_packed(jjoin), jb.valid, 4, 0.2, ms)
    jtable = jsim.build_subtraj_table(jb, jseg, jvoting.point_voting(jjoin),
                                      ms)
    jfn = jsim.contribution_panel_raw(
        *jsim.scatter_operands(jjoin, jseg, jseg.sub_local, S, ms), S, panel)
    _close_lists(tsim.topk_stream(fn, table, k=6, panel=panel),
                 jsim.topk_stream(jfn, jtable, k=6, panel=panel), S)


# ---------------------------------------------------------------------------
# Clustering on the lists
# ---------------------------------------------------------------------------


def _instance(seed, S=40, tied=False):
    """``tests/test_torch_clustering.py``'s random instance (tied weights
    and voting when ``tied``), in both packages."""
    rng = np.random.default_rng(seed)
    raw = (rng.integers(1, 5, (S, S)) / 4 if tied
           else rng.uniform(0, 1, (S, S))).astype(np.float32)
    sim = raw * (rng.uniform(0, 1, (S, S)) > 0.5)
    sim = np.maximum(sim, sim.T).astype(np.float32)
    np.fill_diagonal(sim, 0.0)
    valid = rng.uniform(0, 1, S) > 0.1
    sim *= valid[:, None] & valid[None, :]
    voting = (rng.integers(0, 3, S) if tied
              else rng.uniform(0, 5, S)).astype(np.float32)
    card = rng.integers(1, 20, S).astype(np.int32)
    fields = dict(t_start=np.zeros(S, np.float32),
                  t_end=np.ones(S, np.float32), voting=voting, card=card,
                  valid=valid, traj_row=np.arange(S, dtype=np.int32))
    jt = JTable(**{f: jnp.asarray(v) for f, v in fields.items()})
    tt = SubtrajTable(**{f: torch.from_numpy(v) for f, v in fields.items()})
    return sim, jt, tt


@pytest.mark.parametrize("seed", range(3))
def test_topk_list_kernels_match_reference(seed):
    """The plain versions and the wrappers' CPU path against the Pallas
    list kernels in interpret mode."""
    sim, jt, tt = _instance(seed, S=37, tied=seed == 1)
    S = sim.shape[0]
    tk = tsim.topk_from_dense(torch.from_numpy(sim), tt, 9)
    jk = jsim.topk_from_dense(jnp.asarray(sim), jt, 9)
    rng = np.random.default_rng(seed + 50)
    rank = rng.permutation(S).astype(np.int32)
    unres = rng.uniform(size=S) < 0.4
    rep = ~unres & (rng.uniform(size=S) < 0.5)
    valid = rng.uniform(size=S) < 0.9
    T = torch.from_numpy
    jb, jc = jscan(jk.ids, jk.sims, rank, unres, rep, 0.3, interpret=True)
    jw, js = jassign(jk.ids, jk.sims, rank, rep, valid, 0.3, interpret=True)
    for scan, assign in ((topk_round_scan_ref, topk_claim_max_ref),
                         (topk_cluster_round_scan, topk_cluster_assign)):
        b, c = scan(tk.ids, tk.sims, T(rank), T(unres), T(rep), 0.3)
        w, s = assign(tk.ids, tk.sims, T(rank), T(rep), T(valid), 0.3)
        assert np.array_equal(b.numpy(), np.asarray(jb))
        assert np.array_equal(c.numpy(), np.asarray(jc))
        assert np.array_equal(w.numpy(), np.asarray(jw))
        assert np.array_equal(s.numpy(), np.asarray(js))
        assert s.dtype == torch.int32 and bool(b.any()) and bool(c.any())


@pytest.mark.parametrize("seed,kw", [
    (0, dict(alpha_sigma=0.0, k_sigma=0.0)),
    (1, dict(alpha_sigma=0.5, k_sigma=-0.5)),
    (2, dict(alpha_abs=0.2, k_abs=1.0))])
def test_topk_engines_match_reference_and_dense(seed, kw):
    """Every top-K engine: labels equal to the JAX package's; where the
    certificate holds, equal to the port's dense engines (``member_sim``
    too); a warm start from a visit-order prefix equals a cold run."""
    sim, jt, tt = _instance(seed, tied=seed == 1)
    S = sim.shape[0]
    tsim_t = torch.from_numpy(sim)
    p, jp = DSCParams(**kw), JParams(**kw)
    dense = tcl.cluster_sequential(tsim_t, tt, p)
    for k in (5, S):
        tk = tsim.topk_from_dense(tsim_t, tt, k)
        jk = jsim.topk_from_dense(jnp.asarray(sim), jt, k)
        jseq = jcl.cluster_sequential_topk(jk, jt, jp)
        jrounds = jcl.cluster_rounds_topk(jk, jt, jp)
        res = [(tcl.cluster_sequential_topk(tk, tt, p), jseq),
               (tcl.cluster(tk, tt, p, engine="sequential"), jseq),
               (tcl.cluster_rounds_topk(tk, tt, p), jrounds),
               (tcl.cluster_rounds_topk(tk, tt, p, use_kernel=True),
                jrounds)]
        alpha = res[0][0].alpha_used
        certified = int(tsim.topk_overflow(tk, alpha)) == 0
        assert certified == (int(jsim.topk_overflow(
            jk, jrounds.alpha_used)) == 0)
        assert certified or k < S
        for r, jr in res:
            for f in LABELS:
                assert np.array_equal(_np(getattr(r, f)),
                                      np.asarray(getattr(jr, f))), (k, f)
            if certified:
                for f in LABELS + ("member_sim",):
                    assert torch.equal(getattr(r, f), getattr(dense, f))
        cold, rounds = tcl.cluster_rounds_topk(tk, tt, p, with_rounds=True)
        order, _ = tcl.visit_order(tt)
        seed_resolved = torch.zeros(S, dtype=torch.bool)
        seed_resolved[order[:S // 3].long()] = True
        warm = tcl.cluster_rounds_topk(
            tk, tt, p, seed_resolved=seed_resolved,
            seed_is_rep=cold.is_rep & seed_resolved)
        for f in LABELS + ("member_sim",):
            assert torch.equal(getattr(warm, f), getattr(cold, f))
        assert rounds >= 1
        np.testing.assert_allclose(
            float(tcl.sscr_from_result(res[2][0])),
            float(jcl.sscr_from_result(jrounds)), rtol=1e-5)


# ---------------------------------------------------------------------------
# run_dsc end to end
# ---------------------------------------------------------------------------


def _scenario(name):
    if name.startswith("fig1"):
        jb = jsyn.figure1_scenario(n_per_route=4, points_per_leg=24,
                                   seed=0)[0]
        return jb, dict(FIG1, segmentation=name[5:]), {}
    jb = jsyn.ais_like(n_vessels=24, max_points=96, seed=1)[0]
    diam, mean_dt = jsyn.default_dsc_params_for(jb)
    return jb, dict(eps_sp=0.15 * diam, eps_t=mean_dt, delta_t=0.0, w=12,
                    tau=0.4, alpha_sigma=-1.0, k_sigma=-1.0,
                    segmentation="tsa2"), KERNEL_FLAGS


@pytest.mark.parametrize("scenario,mode", [
    ("fig1_tsa2", "materialize"), ("fig1_tsa2", "fused"),
    ("fig1_tsa1", "materialize"), ("fig1_tsa1", "fused"),
    ("ais", "materialize"), ("ais", "fused")])
def test_run_dsc_topk_matches_reference(scenario, mode):
    """Labels, ``sim_overflow`` and the final K equal to the JAX package's
    top-K run; labels, sscr and rmse bitwise the port's dense run's."""
    jb, kw, flags = _scenario(scenario)
    jo = jdsc.run_dsc(jb, JParams(**kw), mode=mode, sim_mode="topk",
                      **flags)
    tb, p = _port(jb), DSCParams(**kw)
    to = tdsc.run_dsc(tb, p, device="cpu",
                      plan=EnginePlan(mode=mode, sim_mode="topk", **flags))
    dense = tdsc.run_dsc(tb, p, device="cpu",
                         plan=EnginePlan(mode=mode, **flags))
    assert to.sim is None and jo.sim is None
    assert to.sim_topk.k == jo.sim_topk.k
    assert int(to.sim_overflow) == int(jo.sim_overflow) == 0
    for f in LABELS:
        assert np.array_equal(np.asarray(getattr(jo.result, f)),
                              getattr(to.result, f).numpy()), f
    for f in LABELS + ("member_sim",):
        assert torch.equal(getattr(to.result, f), getattr(dense.result, f))
    assert torch.equal(to.sscr, dense.sscr)
    assert torch.equal(to.rmse, dense.rmse)
    for a, b in ((to.sscr, jo.sscr), (to.rmse, jo.rmse),
                 (to.result.alpha_used, jo.result.alpha_used)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    _assert_lists_equal(to.sim_topk, tsim.topk_from_dense(
        dense.sim, dense.table, to.sim_topk.k))
    assert int(to.result.is_rep.sum()) >= 1
    assert to.dispatches == int(np.log2(to.sim_topk.k // 32)) + 1


def test_on_overflow_policies():
    """A small K widens to the reference's final K (its dispatches are
    counted and its stage times summed); ``"raise"`` raises the
    reference's error; ``"degrade"`` returns the violations."""
    jb, kw, _ = _scenario("fig1_tsa2")
    jo = jdsc.run_dsc(jb, JParams(**kw), sim_mode="topk", sim_topk=2)
    tb, p = _port(jb), DSCParams(**kw)
    times = {}
    plan = EnginePlan(mode="fused", sim_mode="topk", sim_topk=2)
    to = tdsc.run_dsc(tb, p, device="cpu", plan=plan, stage_times=times)
    assert to.sim_topk.k == jo.sim_topk.k > 2
    assert to.dispatches == int(np.log2(to.sim_topk.k // 2)) + 1
    assert int(to.sim_overflow) == 0
    assert [k for k in times if "." not in k] == list(tdsc.STAGES)
    for f in LABELS:
        assert np.array_equal(np.asarray(getattr(jo.result, f)),
                              getattr(to.result, f).numpy()), f
    with pytest.raises(RuntimeError, match=r"sim_topk=2 truncated a "
                       r"potential alpha-edge on \d+ rows \(spill >= "
                       r"alpha\): labels would not be exact\.  Raise "
                       r"sim_topk or enable sim_topk_retry\."):
        tdsc.run_dsc(tb, p, device="cpu", plan=plan, on_overflow="raise")
    with pytest.raises(RuntimeError, match="sim_topk"):
        jdsc.run_dsc(jb, JParams(**kw), sim_mode="topk", sim_topk=2,
                     on_overflow="raise")
    deg = tdsc.run_dsc(tb, p, device="cpu", plan=plan, on_overflow="degrade")
    assert int(deg.sim_overflow) > 0 and deg.sim_topk.k == 2
    assert deg.dispatches == 1
    with pytest.raises(ValueError, match="on_overflow='drop': expected "
                       "'raise', 'widen', or 'degrade'"):
        tdsc.run_dsc(tb, p, device="cpu", plan=plan, on_overflow="drop")


@pytest.mark.parametrize("seed", range(6))
def test_sort_and_merge_topk_lists_match_reference(seed):
    """``sort_topk_lists`` / ``merge_topk_lists``: the reference's
    canonical (sim desc, id asc) order on random lists with many ties,
    ``-0.0`` beside ``+0.0`` and -1 padding ids, bitwise (sims compared as
    bit patterns).  ``lax.sort`` does not tell the two zeros apart either:
    equal under both sorts, they keep the id order."""
    rng = np.random.default_rng(seed)
    S, W = 24, 10
    pool = np.array([0.0, -0.0, 0.125, 0.25, 0.5, 0.75], np.float32)
    ids = np.stack([rng.permutation(60)[:W] for _ in range(S)]).astype(
        np.int32)
    ids[rng.random((S, W)) < 0.2] = -1
    sims = rng.choice(pool, (S, W))
    for kk in (1, 5, W, W + 3):
        want = jsim.sort_topk_lists(jnp.asarray(ids), jnp.asarray(sims), kk)
        got = tsim.sort_topk_lists(torch.from_numpy(ids),
                                   torch.from_numpy(sims), kk)
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        assert np.array_equal(got[1].numpy().view(np.int32),
                              np.asarray(want[1]).view(np.int32))
    a, b = slice(0, 4), slice(4, W)
    want = jsim.merge_topk_lists(jnp.asarray(ids[:, a]),
                                 jnp.asarray(sims[:, a]),
                                 jnp.asarray(ids[:, b]),
                                 jnp.asarray(sims[:, b]), 6)
    got = tsim.merge_topk_lists(*(torch.from_numpy(x) for x in (
        ids[:, a], sims[:, a], ids[:, b], sims[:, b])), 6)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy().view(np.int32),
                          np.asarray(want[1]).view(np.int32))
