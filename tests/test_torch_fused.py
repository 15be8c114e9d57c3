"""PyTorch port: the fused streaming join (``mode="fused"``) held against
``repro``'s fused path.

Pass 1 (``stjoin_vote_fused_arrays``, K2), pass 2
(``stjoin_sim_fused_arrays``, K4), the delta_t refine and ``run_dsc``
end to end run on the same numpy-generated inputs through the JAX package
(Pallas in interpret mode) and through the port's plain versions on the
CPU.  Tolerances and why:

* packed words, ``best_idx``-driven slots, segmentation and labels are
  equal;
* ``vote`` and ``raw`` of the passes to 1e-5 absolute: the Pallas kernel
  sums blocks of candidates and scatters in tile order, the port in
  ascending candidate order; and XLA contracts the interpreted kernel's
  ``dx*dx + dy*dy`` into an FMA, so single weights may sit an ulp
  (1.2e-7) apart;
* end to end, ``sim`` to 1e-5 absolute, ``vote`` / ``alpha`` / ``k`` /
  ``sscr`` / ``rmse`` to 1e-5 relative: the same sums, and vector sums in
  another order (measured: vote at most 4e-7 relative).
"""
import numpy as np
import pytest
import torch

from repro.core import dsc as jdsc
from repro.core import geometry as jgeo
from repro.core.types import DSCParams as JParams
from repro.core.types import JoinResult as JJoin
from repro.core.types import TrajectoryBatch as JB
from repro.data import synthetic as jsyn
from repro.kernels.stjoin import ops as jops
from repro_torch.core import dsc as tdsc
from repro_torch.core.geometry import filter_delta_t
from repro_torch.core.plan import EnginePlan
from repro_torch.core.types import DSCParams, JoinResult, TrajectoryBatch
from repro_torch.kernels.stjoin import ops as tops
from repro_torch.kernels.stjoin.ref import run_refine

torch.set_num_threads(1)

FIELDS = ("x", "y", "t", "valid", "traj_id")
ATOL = 1e-5
FIG1 = dict(eps_sp=0.42, eps_t=1.0, delta_t=0.0, w=6, tau=0.15,
            alpha_sigma=-1.0, k_sigma=-1.0)
KERNEL_FLAGS = dict(seg_use_kernel=True, cluster_use_kernel=True)


def _port(jb):
    return TrajectoryBatch.from_arrays(
        *(np.asarray(getattr(jb, f)) for f in FIELDS), device="cpu")


def _rand_batch(rng, T, M, pad_row=None):
    """``tests/test_fused_join.py``'s random batch: time-sorted rows,
    15% invalid points, optionally one all-padding row."""
    x = rng.uniform(0, 10, (T, M)).astype(np.float32)
    y = rng.uniform(0, 10, (T, M)).astype(np.float32)
    t = np.sort(rng.uniform(0, 50, (T, M)), axis=1).astype(np.float32)
    v = rng.uniform(0, 1, (T, M)) > 0.15
    ids = np.arange(T, dtype=np.int32)
    if pad_row is not None:
        v[pad_row] = False
        ids[pad_row] = -1
    return JB(x=x, y=y, t=t, valid=v, traj_id=ids)


def _arrays(b):
    return tuple(getattr(b, f) for f in ("x", "y", "t", "valid", "traj_id"))


def _pair(name):
    """(ref, cand, eps_sp, eps_t) of one pass-1 / pass-2 case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "self":                  # C = 5: one partial word
        b = _rand_batch(rng, 5, 20, pad_row=2)
        return b, b, 2.5, 12.0
    if name == "cross":                 # T != C, M != Mc, C = 37: two words
        return (_rand_batch(rng, 5, 17, pad_row=0), _rand_batch(rng, 37, 13),
                2.5, 12.0)
    jb = jsyn.ais_like(n_vessels=24, max_points=96, seed=1)[0]
    diam, mean_dt = jsyn.default_dsc_params_for(jb)
    return jb, jb, 0.15 * diam, mean_dt


@pytest.mark.parametrize("name,delta_t,with_masks", [
    ("self", 0.0, True), ("self", 4.0, True), ("self", 4.0, False),
    ("cross", 0.0, False), ("cross", 7.0, True), ("ais", 0.0, True)])
def test_fused_vote_and_words_match_reference(name, delta_t, with_masks):
    """Mirrors ``tests/test_fused_join.py::test_fused_vote_and_masks_
    match_reference`` and ``::test_fused_vote_only_skips_masks``."""
    ref, cand, eps_sp, eps_t = _pair(name)
    jv, jw = jops.stjoin_vote_fused_arrays(
        *_arrays(ref), *_arrays(cand), eps_sp, eps_t, delta_t,
        with_masks=with_masks)
    tr, tc = _port(ref), _port(cand)
    tv, tw = tops.stjoin_vote_fused_arrays(
        *_arrays(tr), *_arrays(tc), eps_sp, eps_t, delta_t,
        with_masks=with_masks)
    assert tv.shape == tr.x.shape and tv.dtype == torch.float32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=ATOL)
    if not with_masks:
        assert jw is None and tw is None
        return
    assert tw.dtype == torch.int32
    assert tw.shape == (*tr.x.shape, -(-cand.x.shape[0] // 32))
    assert np.array_equal(tw.numpy().view(np.uint32), np.asarray(jw))
    assert (tw != 0).any()


@pytest.mark.parametrize("name,delta_t", [("self", 0.0), ("cross", 7.0)])
def test_fused_sim_matches_reference(name, delta_t):
    """Mirrors ``tests/test_fused_join.py::test_fused_sim_matches_
    reference_cross_join``: independent slot maps on both sides, -1 for
    unsegmented points."""
    ref, cand, eps_sp, eps_t = _pair(name)
    rng = np.random.default_rng(7)
    max_subs = 4
    rsub = rng.integers(-1, max_subs, ref.x.shape).astype(np.int32)
    csub = rng.integers(-1, max_subs, cand.x.shape).astype(np.int32)
    want = jops.stjoin_sim_fused(ref, cand, rsub, csub, max_subs, eps_sp,
                                 eps_t, delta_t)
    raw = tops.stjoin_sim_fused(_port(ref), _port(cand),
                                torch.from_numpy(rsub),
                                torch.from_numpy(csub), max_subs, eps_sp,
                                eps_t, delta_t)
    assert raw.shape == np.asarray(want).shape
    np.testing.assert_allclose(raw.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert (raw > 0).sum() > 0


@pytest.mark.parametrize("seed", range(4))
def test_run_refine_equals_filter_delta_t(seed):
    """The flat refine (which ``run_refine`` runs in blocks of rows) is
    bitwise ``filter_delta_t``, the port's and the JAX package's, on
    random matched patterns, time-sorted rows or not."""
    rng = np.random.default_rng(seed)
    T, M, C = 7, 23, 9
    w = np.where(rng.uniform(size=(T, M, C)) < 0.6,
                 rng.uniform(0.01, 1.0, (T, M, C)), 0.0).astype(np.float32)
    idx = np.where(w > 0, rng.integers(0, 11, (T, M, C)), -1).astype(np.int32)
    t = rng.uniform(0, 40, (T, M)).astype(np.float32)
    if seed % 2:
        t = np.sort(t, axis=1)
    delta_t = [0.0, 3.0, 8.5, 20.0][seed]
    want = filter_delta_t(JoinResult(torch.from_numpy(w),
                                     torch.from_numpy(idx)),
                          torch.from_numpy(t), delta_t)
    jw = jgeo.filter_delta_t(JJoin(best_w=w, best_idx=idx), t, delta_t)
    rw, ri = run_refine(torch.from_numpy(w).view(T * M, C),
                        torch.from_numpy(idx).view(T * M, C),
                        torch.from_numpy(t).view(-1), M, delta_t,
                        chunk_elements=2 * M * C)
    assert torch.equal(rw.view(T, M, C), want.best_w)
    assert torch.equal(ri.view(T, M, C), want.best_idx)
    assert np.array_equal(rw.view(T, M, C).numpy(), np.asarray(jw.best_w))
    assert np.array_equal(ri.view(T, M, C).numpy(), np.asarray(jw.best_idx))
    w_only, none = run_refine(torch.from_numpy(w).view(T * M, C), None,
                              torch.from_numpy(t).view(-1), M, delta_t)
    assert none is None and torch.equal(w_only, rw)
    if delta_t > 0.0:
        assert (rw == 0).sum() > (w == 0).sum()


def _scenario(name):
    if name == "fig1_tsa2":
        jb = jsyn.figure1_scenario(n_per_route=4, points_per_leg=24,
                                   seed=0)[0]
        return jb, dict(FIG1, segmentation="tsa2"), {}
    if name == "fig1_tsa1_delta_t":
        jb = jsyn.figure1_scenario(n_per_route=4, points_per_leg=24,
                                   seed=0)[0]
        return jb, dict(FIG1, segmentation="tsa1", delta_t=0.3), {}
    jb = jsyn.ais_like(n_vessels=24, max_points=96, seed=1)[0]
    diam, mean_dt = jsyn.default_dsc_params_for(jb)
    return jb, dict(eps_sp=0.15 * diam, eps_t=mean_dt, delta_t=0.0, w=12,
                    tau=0.4, alpha_sigma=-1.0, k_sigma=-1.0,
                    segmentation="tsa2"), KERNEL_FLAGS


@pytest.mark.parametrize("scenario", ["fig1_tsa2", "fig1_tsa1_delta_t",
                                      "ais_kernel_flags"])
def test_run_dsc_fused_matches_reference(scenario):
    jb, kw, flags = _scenario(scenario)
    jo = jdsc.run_dsc(jb, JParams(**kw), mode="fused", **flags)
    tb, p = _port(jb), DSCParams(**kw)
    to = tdsc.run_dsc(tb, p, device="cpu",
                      plan=EnginePlan(mode="fused", **flags))
    for f in ("member_of", "is_rep", "is_outlier"):
        assert np.array_equal(np.asarray(getattr(jo.result, f)),
                              getattr(to.result, f).numpy()), f
    assert np.array_equal(np.asarray(jo.seg.sub_local),
                          to.seg.sub_local.numpy())
    np.testing.assert_allclose(to.sim.numpy(), np.asarray(jo.sim), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(to.vote.numpy(), np.asarray(jo.vote),
                               rtol=1e-5, atol=0)
    for a, b in ((to.result.alpha_used, jo.result.alpha_used),
                 (to.result.k_used, jo.result.k_used),
                 (to.sscr, jo.sscr), (to.rmse, jo.rmse)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    assert int(to.result.is_rep.sum()) >= 1

    # the port's own materialize path (mirrors tests/test_fused_join.py::
    # test_run_dsc_fused_matches_materializing)
    mo = tdsc.run_dsc(tb, p, device="cpu",
                      plan=EnginePlan(mode="materialize", use_kernel=True,
                                      **flags))
    for f in ("member_of", "is_rep", "is_outlier", "member_sim"):
        assert torch.equal(getattr(mo.result, f), getattr(to.result, f)), f
    np.testing.assert_allclose(to.sim.numpy(), mo.sim.numpy(), rtol=0,
                               atol=ATOL)


def test_fused_stage_times():
    jb, kw, _ = _scenario("fig1_tsa2")
    times = {}
    tdsc.run_dsc(_port(jb), DSCParams(**kw), device="cpu",
                 plan=EnginePlan(mode="fused"), stage_times=times)
    assert [k for k in times if "." not in k] == list(tdsc.STAGES)


@pytest.mark.parametrize("sim_mode", ["topk", "dense"])
def test_fused_use_index_matches_reference(sim_mode):
    """Fused mode with ``use_index=True`` (the pruned passes over one tile
    plan): labels and ``sub_local`` equal to the reference's fused pruned
    run and to the port's unpruned fused run; ``sim`` / the lists bitwise
    the unpruned run's."""
    jb, kw, flags = _scenario("ais_kernel_flags")
    jo = jdsc.run_dsc(jb, JParams(**kw), mode="fused", use_index=True,
                      sim_mode=sim_mode, **flags)
    tb, p = _port(jb), DSCParams(**kw)
    plan = dict(mode="fused", sim_mode=sim_mode, **flags)
    to = tdsc.run_dsc(tb, p, device="cpu",
                      plan=EnginePlan(use_index=True, **plan))
    base = tdsc.run_dsc(tb, p, device="cpu", plan=EnginePlan(**plan))
    for f in ("member_of", "is_rep", "is_outlier"):
        assert np.array_equal(np.asarray(getattr(jo.result, f)),
                              getattr(to.result, f).numpy()), f
        assert torch.equal(getattr(to.result, f), getattr(base.result, f))
    assert np.array_equal(np.asarray(jo.seg.sub_local),
                          to.seg.sub_local.numpy())
    assert torch.equal(to.vote, base.vote)
    if sim_mode == "topk":
        assert to.sim_topk.k == jo.sim_topk.k
        assert torch.equal(to.sim_topk.sims, base.sim_topk.sims)
    else:
        assert torch.equal(to.sim, base.sim)


def test_fused_wrappers_take_tile_plans():
    """The batch- and array-level passes take a ``FusedTilePlan`` and
    give the unpruned outputs; a raw ``tile_ids`` tensor is refused (its
    order and geometry are unchecked)."""
    tb = _port(_pair("self")[0])
    args = (*_arrays(tb), *_arrays(tb), 2.5, 12.0)
    dv, dw = tops.stjoin_vote_fused_arrays(*args)
    v, w = tops.stjoin_vote_fused(tb, tb, 2.5, 12.0, use_index=True)
    assert torch.equal(v, dv) and torch.equal(w, dw)
    plan = tops.plan_fused_tiles(*(tb.x, tb.y, tb.t, tb.valid) * 2, 2.5,
                                 12.0)
    v, w = tops.stjoin_vote_fused_arrays(*args, tile_ids=plan)
    assert torch.equal(v, dv) and torch.equal(w, dw)
    with pytest.raises(TypeError, match="FusedTilePlan"):
        tops.stjoin_vote_fused_arrays(*args, tile_ids=plan.tile_ids)
    sub = torch.from_numpy(np.random.default_rng(0).integers(
        -1, 2, tb.x.shape).astype(np.int32))
    raw = tops.stjoin_sim_fused(tb, tb, sub, sub, 2, 2.5, 12.0)
    assert torch.equal(tops.stjoin_sim_fused(tb, tb, sub, sub, 2, 2.5, 12.0,
                                             tile_ids=plan), raw)
    assert bool((raw > 0).any())


def test_block_slot_contract():
    """K4's slot maps on the card: each row's and each candidate's slots
    inside its own block of ``ms``, or the sentinel; anything else is
    refused before launch (the plain version takes any slot map)."""
    T, M, C, Mc, ms = 3, 5, 4, 6, 2
    rows = torch.arange(T, dtype=torch.int32)[:, None]
    cols = torch.arange(C, dtype=torch.int32)[:, None]
    rg = (rows * ms + torch.arange(M) % ms).to(torch.int32)
    cg = (cols * ms + torch.arange(Mc) % ms).to(torch.int32)
    rg[1, 2] = T * ms
    cg[0, 0] = C * ms
    tops._check_block_slots(rg, cg, ms, T * ms, C * ms)
    for bad_r, bad_c, n in ((rg.clone(), cg, (T * ms, C * ms)),
                            (rg, cg.clone(), (T * ms, C * ms)),
                            (rg, cg, (T * ms + 1, C * ms))):
        if bad_r is not rg:
            bad_r[0, 1] = ms            # row 1's block, on row 0
        if bad_c is not cg:
            bad_c[3, 2] = -1
        with pytest.raises(ValueError):
            tops._check_block_slots(bad_r, bad_c, ms, *n)


# the reference's TPU knobs of the stjoin wrappers, decided from its own
# outputs (README, "The reference's TPU knobs")
NEUTRAL_FUSED = [dict(rows=1), dict(rows=3), dict(bm=8), dict(bm=32),
                 dict(interpret=True), dict(interpret=False)]


def _slot_maps(ref, cand, max_subs=4):
    rng = np.random.default_rng(7)
    return (rng.integers(-1, max_subs, ref.x.shape).astype(np.int32),
            rng.integers(-1, max_subs, cand.x.shape).astype(np.int32))


@pytest.mark.parametrize("name", ["cross", "ais"])
def test_vote_pass_knobs(name):
    """Pass 1: ``rows``, ``bm`` and ``interpret`` leave the reference's
    vote and words bitwise the same, and the port's (ignored); ``bc``
    moves the reference's vote sums, so the port takes only a ``bc`` the
    reference resolves to its default 16, and refuses any other, naming
    it."""
    ref, cand, eps_sp, eps_t = _pair(name)
    args = (*_arrays(ref), *_arrays(cand), eps_sp, eps_t, 3.0)
    jv, jw = jops.stjoin_vote_fused_arrays(*args)
    for kw in (dict(rows=3, bm=8), dict(rows=1, bm=32)):
        v, w = jops.stjoin_vote_fused_arrays(*args, **kw)
        assert np.array_equal(np.asarray(v), np.asarray(jv)), kw
        assert np.array_equal(np.asarray(w), np.asarray(jw)), kw
    moved = jops.stjoin_vote_fused_arrays(*args, bc=8)[0]
    assert not np.array_equal(np.asarray(moved), np.asarray(jv))
    tr, tc = _port(ref), _port(cand)
    targs = (*_arrays(tr), *_arrays(tc), eps_sp, eps_t, 3.0)
    tv, tw = tops.stjoin_vote_fused_arrays(*targs)
    for kw in NEUTRAL_FUSED + [dict(bc=16), dict(bc=20), dict(bc=31)]:
        for got in (tops.stjoin_vote_fused_arrays(*targs, **kw),
                    tops.stjoin_vote_fused(tr, tc, eps_sp, eps_t, 3.0,
                                           **kw)):
            assert torch.equal(got[0], tv) and torch.equal(got[1], tw), kw
    for bc in (1, 8, 32, 0):
        with pytest.raises(ValueError, match=f"bc={bc} moves"):
            tops.stjoin_vote_fused_arrays(*targs, bc=bc)
        with pytest.raises(ValueError, match=f"bc={bc} moves"):
            tops.stjoin_vote_fused(tr, tc, eps_sp, eps_t, bc=bc)
    for bad in (dict(rows=0), dict(bm=-1), dict(bm=2.5)):
        with pytest.raises(ValueError, match="must be a positive int"):
            tops.stjoin_vote_fused_arrays(*targs, **bad)


@pytest.mark.parametrize("name", ["cross", "ais"])
def test_sim_pass_knobs(name):
    """Pass 2, dense and panel: ``rows``, ``bc``, ``bm`` and ``interpret``
    leave the reference's ``raw`` bitwise the same (each cell gets its
    additions from one tile), so the port takes and ignores them."""
    ref, cand, eps_sp, eps_t = _pair(name)
    rsub, csub = _slot_maps(ref, cand)
    jargs = (ref, cand, rsub, csub, 4, eps_sp, eps_t, 3.0)
    jraw = np.asarray(jops.stjoin_sim_fused(*jargs))
    jfwd = np.asarray(jops.stjoin_sim_panel_fused(*jargs, p0=0,
                                                  panel=8)[0])
    knobs = NEUTRAL_FUSED + [dict(bc=1), dict(bc=8), dict(bc=32)]
    for kw in (dict(rows=3, bc=8, bm=8), dict(rows=1, bc=32, bm=32)):
        assert np.array_equal(np.asarray(jops.stjoin_sim_fused(*jargs, **kw)),
                              jraw), kw
        assert np.array_equal(np.asarray(jops.stjoin_sim_panel_fused(
            *jargs, p0=0, panel=8, **kw)[0]), jfwd), kw
    targs = (_port(ref), _port(cand), torch.from_numpy(rsub),
             torch.from_numpy(csub), 4, eps_sp, eps_t, 3.0)
    raw = tops.stjoin_sim_fused(*targs)
    fwd, rev = tops.stjoin_sim_panel_fused(*targs, p0=0, panel=8)
    for kw in knobs:
        assert torch.equal(tops.stjoin_sim_fused(*targs, **kw), raw), kw
        f, r = tops.stjoin_sim_panel_fused(*targs, p0=0, panel=8, **kw)
        assert torch.equal(f, fwd) and torch.equal(r, rev), kw
    with pytest.raises(ValueError, match="bm must be a positive int"):
        tops.stjoin_sim_fused(*targs, bm=0)


def test_plan_fused_tiles_records_bm():
    """``bm`` leaves the reference's tiles as they are and is recorded in
    its plan as ``min(bm, Mc)``; the port's plan records it the same way."""
    ref, cand, eps_sp, eps_t = _pair("ais")
    arrays = lambda b: _arrays(b)[:4]
    tr, tc = _port(ref), _port(cand)
    base = tops.plan_fused_tiles(*arrays(tr), *arrays(tc), eps_sp, eps_t)
    for bm in (8, 32, 128, 1000):
        jp = jops.plan_fused_tiles(*arrays(ref), *arrays(cand), eps_sp,
                                   eps_t, bm=bm)
        tp = tops.plan_fused_tiles(*arrays(tr), *arrays(tc), eps_sp, eps_t,
                                   bm=bm)
        assert tp.bm == jp.bm == min(bm, cand.x.shape[1])
        assert torch.equal(tp.tile_ids, base.tile_ids)
    with pytest.raises(ValueError, match="bm must be a positive int"):
        tops.plan_fused_tiles(*arrays(tr), *arrays(tc), eps_sp, eps_t, bm=0)


@pytest.mark.parametrize("name", ["self", "ais"])
def test_join_knobs(name):
    """The dense and pruned joins: the reference's ``bp`` / ``bc`` / ``bm``
    and ``interpret`` leave its outputs bitwise the same, and the port's
    (``bp`` / ``bc`` of the pruned join are its plan's geometry, as
    before); ``subtrajectory_join`` passes its keywords on, as the
    reference's ``**kw``."""
    ref, cand, eps_sp, eps_t = _pair(name)
    j0 = jops.best_match_join_kernel(ref, cand, eps_sp, eps_t)
    jk = jops.best_match_join_kernel(ref, cand, eps_sp, eps_t, bp=64, bc=4,
                                     bm=8)
    assert np.array_equal(np.asarray(jk.best_w), np.asarray(j0.best_w))
    tr, tc = _port(ref), _port(cand)
    base = tops.best_match_join_kernel(tr, tc, eps_sp, eps_t)
    outs = [tops.best_match_join_kernel(tr, tc, eps_sp, eps_t, bp=64, bc=4,
                                        bm=8, interpret=True),
            tops.best_match_join_pruned(tr, tc, eps_sp, eps_t, bm=8,
                                        interpret=False),
            tops.subtrajectory_join(tr, tc, eps_sp, eps_t, bp=128, bm=16),
            tops.subtrajectory_join(tr, tc, eps_sp, eps_t, use_index=True,
                                    bm=16, use_cells=False)]
    for out in outs:
        assert torch.equal(out.best_w, base.best_w)
        assert torch.equal(out.best_idx, base.best_idx)
    with pytest.raises(ValueError, match="bp must be a positive int"):
        tops.best_match_join_kernel(tr, tc, eps_sp, eps_t, bp=0)
    with pytest.raises(TypeError):
        tops.subtrajectory_join(tr, tc, eps_sp, eps_t, no_such_knob=1)
