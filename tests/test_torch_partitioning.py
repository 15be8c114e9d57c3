"""PyTorch port: the host-side pieces of the multi-device program held
against the JAX package, in this process (no mesh needed).

* ``core/partitioning.py``: edges, slabs, ranges, ``src_m``, the point
  layout, ``gather_global`` and ``repartition`` (both leaf kinds) and
  ``repartition_batch``: bitwise (both are numpy on the host; the slabs
  are torch tensors holding the same bits);
* ``core/refine.py::refine_states``: every field equal, ``member_sim``
  bitwise (a selection, no arithmetic);
* ``core/similarity.py``: ``merge_topk_blocks`` and ``finalize_sim_cols``
  bitwise (a sort and one division per cell); the ``active=`` keywords of
  ``finalize_sim_panel``, ``topk_stream`` and ``topk_from_dense``
  bitwise (the moments are row sums along the same fixed tree);
* ``core/clustering.py``'s ``moments=`` override: labels equal, alpha and
  k to 1e-6 relative (the port sums the moment vectors in PyTorch's
  order, not XLA's; ``tests/test_torch_clustering.py``).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import clustering as jcl
from repro.core import partitioning as jpart
from repro.core import similarity as jsim
from repro.core.refine import refine_states as jrefine
from repro.core.types import DSCParams as JParams
from repro.core.types import SubtrajTable as JTable
from repro.data import synthetic as jsyn
from repro_torch.core import clustering as tcl
from repro_torch.core import partitioning as tpart
from repro_torch.core import similarity as tsim
from repro_torch.core.refine import refine_states as trefine
from repro_torch.core.types import DSCParams, SubtrajTable, TrajectoryBatch

torch.set_num_threads(1)

BATCH = ("x", "y", "t", "valid", "traj_id")
SLABS = ("x", "y", "t", "valid", "traj_id", "ranges")
LISTS = ("ids", "sims", "spill", "degree", "row_sum", "row_sumsq")
LABELS = ("member_of", "is_rep", "is_outlier")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype)
    assert np.array_equal(a.reshape(-1).view(np.uint8),
                          b.reshape(-1).view(np.uint8)), what


def _port(jb):
    return TrajectoryBatch.from_arrays(
        *(np.asarray(getattr(jb, f)) for f in BATCH), device="cpu")


def _scenario(name):
    if name == "fig1":
        return jsyn.figure1_scenario(n_per_route=4, points_per_leg=24,
                                     seed=0)[0]
    return jsyn.ais_like(n_vessels=24, max_points=96, seed=1)[0]


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------


def _times(kind):
    rng = np.random.default_rng(3)
    if kind == "uniform":
        return rng.uniform(0, 100, 5000).astype(np.float32)
    if kind == "skewed":     # most points on a few instants: duplicate edges
        t = rng.choice(np.float32([0.0, 1.0, 1.0, 1.0, 7.5]), 4000)
        return np.concatenate([t, np.float32([-0.0, 2.0])])
    return rng.normal(0, 1, 150_000).astype(np.float32)   # sampled


@pytest.mark.parametrize("kind", ["uniform", "skewed", "sampled"])
@pytest.mark.parametrize("P", [1, 2, 3, 8])
def test_equi_depth_edges_bitwise(kind, P):
    t = _times(kind)
    want = jpart.equi_depth_edges(t, P)
    got = tpart.equi_depth_edges(torch.from_numpy(t), P)
    _same(got, want, (kind, P))
    assert np.all(np.diff(got) > 0)


@pytest.mark.parametrize("name,P", [("fig1", 1), ("fig1", 2), ("fig1", 4),
                                    ("ais", 2), ("ais", 3)])
def test_partition_batch_bitwise(name, P):
    jb = _scenario(name)
    want = jpart.partition_batch(jb, P)
    got = tpart.partition_batch(_port(jb), P)
    for f in SLABS:
        _same(getattr(got, f), getattr(want, f), f)
        assert getattr(got, f).device.type == "cpu"
    _same(got.edges, want.edges, "edges")
    _same(got.src_m, want.src_m, "src_m")
    assert got.num_partitions == P


def test_layout_gather_repartition_bitwise():
    """Both leaf kinds through ``gather_global`` and ``repartition`` to a
    layout at other edges and P, and ``repartition_batch``."""
    jb = _scenario("ais")
    jp, tp = jpart.partition_batch(jb, 3), tpart.partition_batch(_port(jb), 3)
    jl, tl = jpart.PointLayout.from_parts(jp), tpart.PointLayout.from_parts(tp)
    for f in ("edges", "t", "valid", "p_of", "r_of", "m_of", "slot",
              "src_m"):
        _same(getattr(tl, f), getattr(jl, f), f)
    assert tl.Mp == jl.Mp and tl.same_layout(tl)
    rng = np.random.default_rng(0)
    Pn, T, Mp = jp.x.shape
    point = rng.uniform(size=(Pn, T, Mp, 2)).astype(np.float32)
    cand = rng.integers(0, 3 * Mp, size=(Pn, T, Mp, T)).astype(np.int32)
    edges = np.concatenate([[-np.inf], np.quantile(
        np.asarray(jb.t)[np.asarray(jb.valid)], [0.3, 0.5, 0.9]), [np.inf]])
    jn = jpart.PointLayout.from_global(jl.t, jl.valid, edges)
    tn = tpart.PointLayout.from_global(torch.from_numpy(tl.t),
                                       torch.from_numpy(tl.valid), edges)
    for kind, leaf in (("point", point), ("cand_idx", cand)):
        _same(tpart.gather_global(torch.from_numpy(leaf), tl, kind=kind),
              jpart.gather_global(leaf, jl, kind=kind), kind)
        _same(tpart.repartition(torch.from_numpy(leaf), tl, tn, kind=kind),
              jpart.repartition(leaf, jl, jn, kind=kind), kind)
    with pytest.raises(ValueError, match="kind="):
        tpart.gather_global(point, tl, kind="other")
    jr = jpart.repartition_batch(jp, edges)
    tr = tpart.repartition_batch(tp, edges)
    for f in SLABS:
        _same(getattr(tr, f), getattr(jr, f), f)
    _same(tr.src_m, jr.src_m, "src_m")
    bare = tpart.PartitionedBatch(tp.x, tp.y, tp.t, tp.valid, tp.traj_id,
                                  tp.ranges)
    with pytest.raises(ValueError, match="no layout record"):
        tpart.PointLayout.from_parts(bare)


# ---------------------------------------------------------------------------
# refine, similarity column blocks, top-K merges, active masks, moments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_refine_states_matches_reference(seed):
    """Replicated rows with every case of the table: reps in one
    partition, members in several (tied similarities: the first
    partition wins), outliers, unseen slots."""
    rng = np.random.default_rng(seed)
    P, S = 3, 64
    member_of = rng.integers(-1, S, (P, S)).astype(np.int32)
    member_sim = (rng.integers(0, 4, (P, S)) / 4).astype(np.float32)
    is_rep = rng.uniform(size=(P, S)) < 0.1
    member_sim[is_rep] = np.inf
    valid = rng.uniform(size=(P, S)) < 0.6
    alpha, k = np.float32(0.3), np.float32(1.5)
    want = jrefine(*(jnp.asarray(a) for a in (member_of, member_sim, is_rep,
                                              valid, alpha, k)))
    got = trefine(*(torch.from_numpy(np.asarray(a)) for a in (
        member_of, member_sim, is_rep, valid, alpha, k)))
    for f in LABELS + ("member_sim", "alpha_used", "k_used"):
        _same(getattr(got, f), getattr(want, f), f)


def _tied(rng, R, C):
    x = (rng.integers(0, 5, (R, C)) / 4).astype(np.float32)
    x[rng.uniform(size=R) < 0.2] = 0.0
    return x


@pytest.mark.parametrize("k", [1, 4, 9, 40])
def test_merge_topk_blocks_matches_reference(k):
    """Per-block top-(K+1) lists of disjoint column ranges, concatenated
    rank-major (the barrier merge), with ties across blocks."""
    rng = np.random.default_rng(k)
    S, B, C = 17, 3, 12
    vals, ids = [], []
    for b in range(B):
        blk = _tied(rng, S, C)
        kk = min(k + 1, C)
        v, i = jsim.jax.lax.top_k(jnp.asarray(blk), kk)
        vals.append(np.asarray(v))
        ids.append(np.asarray(i, np.int32) + b * C)
    m_ids, m_vals = np.concatenate(ids, 1), np.concatenate(vals, 1)
    want = jsim.merge_topk_blocks(jnp.asarray(m_ids), jnp.asarray(m_vals), k)
    got = tsim.merge_topk_blocks(torch.from_numpy(m_ids),
                                 torch.from_numpy(m_vals), k)
    for g, w in zip(got, want):
        _same(g, w)


def _table(rng, S):
    card = rng.integers(1, 9, S).astype(np.int32)
    valid = rng.uniform(size=S) < 0.85
    arrs = dict(t_start=np.zeros(S, np.float32), t_end=np.ones(S, np.float32),
                voting=rng.uniform(0, 3, S).astype(np.float32), card=card,
                valid=valid, traj_row=np.arange(S, dtype=np.int32))
    jt = JTable(**{f: jnp.asarray(a) for f, a in arrs.items()})
    tt = SubtrajTable(**{f: torch.from_numpy(a) for f, a in arrs.items()})
    return jt, tt


@pytest.mark.parametrize("with_active", [False, True])
@pytest.mark.parametrize("c0", [0, 12, 24])
def test_finalize_sim_cols_matches_reference(c0, with_active):
    rng = np.random.default_rng(c0)
    S, S_loc = 36, 12
    jt, tt = _table(rng, S)
    blk = (rng.uniform(0, 3, (S, S_loc))
           * (rng.uniform(size=(S, S_loc)) < 0.5)).astype(np.float32)
    act = rng.uniform(size=S) < 0.7 if with_active else None
    want = jsim.finalize_sim_cols(jnp.asarray(blk), c0, jt,
                                  None if act is None else jnp.asarray(act))
    got = tsim.finalize_sim_cols(torch.from_numpy(blk), c0, tt,
                                 None if act is None else
                                 torch.from_numpy(act))
    _same(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_active_keywords_match_reference(seed):
    """``active=`` on ``finalize_sim_panel``, ``topk_stream`` and
    ``topk_from_dense``: bitwise the reference's, and the panel sweep
    equal to the dense reduction under the same mask."""
    rng = np.random.default_rng(seed)
    S, Sb, k = 40, 8, 6
    jt, tt = _table(rng, S)
    raw = (rng.integers(0, 5, (S, S)) / 4
           * (rng.uniform(size=(S, S)) < 0.4)).astype(np.float32)
    act = rng.uniform(size=S) < 0.7
    ja, ta = jnp.asarray(act), torch.from_numpy(act)
    jraw, traw = jnp.asarray(raw), torch.from_numpy(raw)
    for p0 in (0, 16, 32):
        want = jsim.finalize_sim_panel(jraw[p0:p0 + Sb], jraw.T[p0:p0 + Sb],
                                       p0, jt, active=ja)
        got = tsim.finalize_sim_panel(traw[p0:p0 + Sb], traw.T[p0:p0 + Sb],
                                      p0, tt, active=ta)
        _same(got, want, p0)
    want = jsim.topk_stream(lambda p: (jax_rows(jraw, p, Sb),
                                       jax_rows(jraw.T, p, Sb)),
                            jt, k=k, panel=Sb, active=ja)
    got = tsim.topk_stream(lambda p: (traw[p:p + Sb], traw.T[p:p + Sb]), tt,
                           k=k, panel=Sb, active=ta)
    dense = np.array(jsim.finalize_sim(jraw, jt))
    want_d = jsim.topk_from_dense(jnp.asarray(dense), jt, k, active=ja)
    got_d = tsim.topk_from_dense(torch.from_numpy(dense), tt, k, active=ta)
    for f in LISTS:
        _same(getattr(got, f), getattr(want, f), f)
        _same(getattr(got_d, f), getattr(want_d, f), f)
        _same(getattr(got, f), getattr(got_d, f), f)


def jax_rows(a, p0, n):
    return jsim.jax.lax.dynamic_slice_in_dim(a, p0, n, axis=0)


@pytest.mark.parametrize("engine", ["rounds", "sequential"])
@pytest.mark.parametrize("seed", [0, 1])
def test_moments_override_matches_reference(engine, seed):
    """``moments=`` replaces the pass over the matrix: scaled moments move
    alpha as they move the reference's, on ``resolve_thresholds``,
    ``cluster_sequential`` / ``cluster_rounds`` and ``cluster``."""
    rng = np.random.default_rng(seed)
    S = 48
    jt, tt = _table(rng, S)
    sim = ((rng.integers(1, 9, (S, S)) / 8)
           * (rng.uniform(size=(S, S)) < 0.3)).astype(np.float32)
    sim = np.maximum(sim, sim.T)
    np.fill_diagonal(sim, 0.0)
    kw = dict(alpha_sigma=0.3, k_sigma=-0.2)
    jp, tp = JParams(**kw), DSCParams(**kw)
    jm = jsim.sim_row_moments(jnp.asarray(sim), jt.valid, jt.valid)
    jm = (jm[0], jm[1] * 1.5, jm[2] * 1.5)
    tm = tuple(torch.from_numpy(np.asarray(m)) for m in jm)
    ja, jk = jcl.resolve_thresholds(jp, jnp.asarray(sim), jt, moments=jm)
    ta, tk = tcl.resolve_thresholds(tp, torch.from_numpy(sim), tt,
                                    moments=tm)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    np.testing.assert_allclose(float(tk), float(jk), rtol=1e-6)
    plain_a, _ = tcl.resolve_thresholds(tp, torch.from_numpy(sim), tt)
    assert float(plain_a) != float(ta)
    want = jcl.cluster(jnp.asarray(sim), jt, jp, engine=engine, moments=jm)
    got = tcl.cluster(torch.from_numpy(sim), tt, tp, engine=engine,
                      moments=tm)
    for f in LABELS:
        _same(getattr(got, f), getattr(want, f), f)
    np.testing.assert_allclose(float(got.alpha_used),
                               float(want.alpha_used), rtol=1e-6)
    direct = (tcl.cluster_sequential(torch.from_numpy(sim), tt, tp,
                                     moments=tm)
              if engine == "sequential" else
              tcl.cluster_rounds(torch.from_numpy(sim), tt, tp, moments=tm))
    for f in LABELS:
        assert torch.equal(getattr(direct, f), getattr(got, f)), f
