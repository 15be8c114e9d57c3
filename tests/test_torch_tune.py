"""PyTorch port: the plan autotuner (``repro_torch.tune``) held against
``repro.tune.autotune`` on the CPU.

Both packages get the same inputs, built once with numpy (the conftest
generators).  What must agree:

* the pure pieces: shape buckets and the four candidate lists, equal;
* the store: one JSON layout, a file of either package loads in the
  other and saves back byte for byte, ``get`` finds only its own
  package's keys;
* the sweeps: the reference's ranking and rejection rules, every real
  sweep verifying all its candidates, the join sweep's interface bytes
  equal to the reference's HLO interface bytes, labels equal;
* the dense panel oracle's raw scatter: bitwise the reference's
  ``.at[src, dst].add`` on a list with repeated pairs (both add each
  cell's entries in list order).

The cluster oracle's labels and ``member_sim`` must be the reference's
bit for bit; its ``alpha_used`` / ``k_used`` within 1e-6 relative: the
threshold means reduce in another order than XLA's (ROADMAP Queue 3's
ulp-level sums).  Within the port, every sweep compares all six fields
bitwise.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jclust
from repro.core import dsc as jdsc
from repro.core.plan import EnginePlan as JPlan
from repro.core.types import DSCParams as JParams
from repro.core.types import SubtrajTable as JTable
from repro.tune import autotune as jtune
from repro_torch.core import dsc as tdsc
from repro_torch.core import similarity as tsim
from repro_torch.core.clustering import cluster_rounds
from repro_torch.core.plan import EnginePlan
from repro_torch.core.types import DSCParams, SubtrajTable, TrajectoryBatch
from repro_torch.tune import autotune as ttune

torch.set_num_threads(1)

FIELDS = ("x", "y", "t", "valid", "traj_id")
FIG1 = dict(eps_sp=0.42, eps_t=1.0, delta_t=0.0, w=6, tau=0.15,
            alpha_sigma=-1.0, k_sigma=-1.0, segmentation="tsa2")
LABELS = ("member_of", "is_rep", "is_outlier")
CLUSTER_FIELDS = ("member_of", "member_sim", "is_rep", "is_outlier",
                  "alpha_used", "k_used")


def _port(jb):
    return TrajectoryBatch.from_arrays(
        *(np.asarray(getattr(jb, f)) for f in FIELDS), device="cpu")


def _same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = got.numpy()
    return got.dtype == want.dtype and np.array_equal(got, want)


@pytest.fixture(scope="module")
def fig1_both(fig1):
    """(reference batch, port batch, reference params, port params)."""
    jb, _ = fig1
    return jb, _port(jb), JParams(**FIG1), DSCParams(**FIG1)


@pytest.fixture(scope="module")
def fig1_ref_labels(fig1_both):
    """The reference's labels on fig1 (materialize, the default plan)."""
    jb, _, jp, _ = fig1_both
    out = jdsc.run_dsc_lowerable(jb, jp, JPlan())
    return {f: np.asarray(getattr(out.result, f)) for f in LABELS}


# --------------------------------------------------------------------------
# the pure pieces
# --------------------------------------------------------------------------

def test_shape_bucket_equal_over_a_grid():
    for dims in ({"T": v} for v in (0, 1, 2, 3, 24, 100, 128, 129, 4096)):
        assert ttune.shape_bucket(**dims) == jtune.shape_bucket(**dims)
    for T, M, S, K in ((24, 48, 192, 32), (4096, 128, 32768, 4096),
                       (3, 7, 300, 5), (1, 1, 1, 1)):
        assert (ttune.shape_bucket(T=T, M=M, S=S, K=K)
                == jtune.shape_bucket(T=T, M=M, S=S, K=K))
        assert (ttune.shape_bucket(S=S, K=K, P=2, M=M)
                == jtune.shape_bucket(S=S, K=K, P=2, M=M))


BASES = {"default": {}, "sim_panel": dict(sim_panel=100, sim_topk=16),
         "fused_kernels": dict(mode="fused", use_kernel=True,
                               seg_use_kernel=True, cluster_use_kernel=True),
         "sequential": dict(cluster_engine="sequential", cluster_bs=64,
                            halo_stream="ring")}


@pytest.mark.parametrize("base", sorted(BASES))
@pytest.mark.parametrize("S", [192, 300, 32768])
def test_candidate_lists_equal(base, S):
    """The four lists, as ``to_dict``s, for (T, M) = (S / 8, 48 / 128 / 7)
    and each base."""
    tb, jb = EnginePlan(**BASES[base]), JPlan(**BASES[base])

    def dicts(plans):
        return [p.to_dict() for p in plans]

    for M in (7, 48, 128):
        assert dicts(ttune.join_candidates(S // 8, M, tb)) == \
            dicts(jtune.join_candidates(S // 8, M, jb))
    assert dicts(ttune.cluster_candidates(S, tb)) == \
        dicts(jtune.cluster_candidates(S, jb))
    assert dicts(ttune.panel_candidates(S, tb)) == \
        dicts(jtune.panel_candidates(S, jb))
    assert dicts(ttune.comm_candidates(tb)) == \
        dicts(jtune.comm_candidates(jb))


# --------------------------------------------------------------------------
# the sweep (tests/test_plan.py's four, on a real measure_call)
# --------------------------------------------------------------------------

def _fake_measure(sizes, walls):
    """Injectable measure: a real ``measure_call`` of a tiny tensor
    program per candidate (a result of n float32, so interface bytes =
    4n), candidate-keyed wall-clock."""
    def measure(plan):
        n = sizes[plan.cluster_bs]
        _, _, buffers = ttune.measure_call(lambda v: v + 1.0,
                                           (torch.zeros(n),), device="cpu")
        return plan.cluster_bs, walls[plan.cluster_bs], buffers
    return measure


_CANDS = [EnginePlan(),                       # default: bs=128
          EnginePlan(cluster_bs=64),
          EnginePlan(cluster_bs=32)]
_SIZES = {128: 1024, 64: 512, 32: 256}        # interface bytes = 4n
_WALLS = {128: 3e-3, 64: 2e-3, 32: 1e-3}


def _run_fixed_sweep(verify=None, store=None):
    return ttune.sweep("unit", "S256", _CANDS,
                       _fake_measure(_SIZES, _WALLS),
                       verify or (lambda out, plan: True), store=store,
                       backend="cpu")


def test_sweep_deterministic_on_fixed_candidates():
    a = _run_fixed_sweep()
    b = _run_fixed_sweep()
    assert a.winner.plan == b.winner.plan == EnginePlan(cluster_bs=32)
    assert [c.plan for c in a.candidates] == [c.plan for c in b.candidates]
    assert ([c.peak_interface_bytes for c in a.candidates]
            == [4 * _SIZES[p.cluster_bs] for p in _CANDS])
    assert a.default.plan == EnginePlan()
    assert a.winner.peak_interface_bytes <= a.default.peak_interface_bytes
    assert all(c.peak_buffer_bytes is None and c.roofline is None
               for c in a.candidates)
    assert a.backend == "cpu"


def test_sweep_rejects_bit_unidentical_candidate():
    res = _run_fixed_sweep(verify=lambda out, plan: plan.cluster_bs != 32)
    rejected = [c for c in res.candidates if not c.verified]
    assert len(rejected) == 1 and rejected[0].plan.cluster_bs == 32
    assert rejected[0].note == "rejected: not bit-identical to the oracle"
    assert res.winner.plan == EnginePlan(cluster_bs=64)


def test_sweep_raises_when_nothing_verifies():
    with pytest.raises(RuntimeError, match="no candidate survived") as te:
        _run_fixed_sweep(verify=lambda out, plan: False)
    assert str(te.value) == (
        "tune[unit]: no candidate survived verification "
        f"({['rejected: not bit-identical to the oracle'] * 3})")


def test_sweep_survives_a_failing_measure():
    def measure(plan):
        if plan.cluster_bs == 64:
            raise ValueError("invalid geometry")
        return _fake_measure(_SIZES, _WALLS)(plan)
    res = ttune.sweep("unit", "S256", _CANDS, measure, lambda o, p: True,
                      backend="cpu")
    failed = [c for c in res.candidates if "measure failed" in c.note]
    assert len(failed) == 1 and not failed[0].verified
    assert failed[0].note == "measure failed: invalid geometry"
    assert failed[0].to_dict()["wall_s"] is None
    assert res.winner.plan == EnginePlan(cluster_bs=32)


def test_sweep_without_a_card_raises():
    """No backend and no card: the device is the card, which is missing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttune.sweep("unit", "S256", _CANDS, _fake_measure(_SIZES, _WALLS),
                    lambda o, p: True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttune.measure_call(lambda v: v, (torch.zeros(1),))


# --------------------------------------------------------------------------
# the plan store
# --------------------------------------------------------------------------

def test_plan_store_round_trips_both_ways(tmp_path):
    """A reference store loads in the port and saves back byte for byte;
    the port's records load in the reference; each package's ``get``
    finds only its own keys; ``put`` keys a result by the backend it was
    measured on."""
    hlo = jax.jit(lambda v: v + 1.0).lower(
        jnp.zeros((8,), jnp.float32)).compile().as_text()
    jres = jtune.sweep("unit", "S256", [JPlan(), JPlan(cluster_bs=64)],
                       lambda plan: (0, 1e-3 * plan.cluster_bs, hlo),
                       lambda o, p: True)
    jstore = jtune.PlanStore(str(tmp_path / "ref.json"))
    jkey = jstore.put(jres)
    jstore.save()
    text = (tmp_path / "ref.json").read_text()

    tstore = ttune.PlanStore(str(tmp_path / "ref.json"))
    assert tstore.records == json.loads(text)
    assert tstore.get("unit", "S256", backend="cpu") is None
    tstore.save(str(tmp_path / "back.json"))
    assert (tmp_path / "back.json").read_text() == text

    tres = _run_fixed_sweep()
    tkey = tstore.put(tres)
    assert tkey == f"unit|S256|cpu|torch{torch.__version__}" != jkey
    assert tstore.get("unit", "S256", backend="cpu") == EnginePlan(
        cluster_bs=32)
    assert tstore.get("unit", "S256", backend="cpu",
                      torch_version="0.0") is None
    rec = tstore.records[tkey]
    assert rec["backend"] == "cpu" and rec["torch"] == torch.__version__
    assert rec["plan"] == rec["winner"]["plan"]
    assert len(rec["candidates"]) == 3
    tstore.save(str(tmp_path / "both.json"))
    both = (tmp_path / "both.json").read_text()

    jboth = jtune.PlanStore(str(tmp_path / "both.json"))
    assert set(jboth.records) == {jkey, tkey}
    assert jboth.records[jkey] == json.loads(text)[jkey]
    assert jboth.get("unit", "S256").to_dict() == jres.winner.plan.to_dict()
    jboth.save()
    assert (tmp_path / "both.json").read_text() == both
    port_only = jtune.PlanStore()
    port_only.records = {tkey: jboth.records[tkey]}
    assert port_only.get("unit", "S256") is None
    with pytest.raises(ValueError, match="no path"):
        ttune.PlanStore().save()


def test_plan_cache_key_names_the_card_by_default():
    assert ttune.plan_cache_key("join", "M64-T32", "gpu", "9.9") == \
        "join|M64-T32|gpu|torch9.9"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttune.plan_cache_key("join", "M64-T32")


# --------------------------------------------------------------------------
# real stage sweeps
# --------------------------------------------------------------------------

def test_tune_join_fig1_matches_reference(fig1_both, fig1_ref_labels):
    """The two candidates of ``tests/test_plan.py``'s join sweep: both
    verified in both packages, the port's interface bytes equal to the
    reference's HLO interface bytes for each (the ``[S, S]`` f32
    similarity, 147,456 bytes), and the port's oracle labels the
    reference's."""
    jb, tb, jp, tp = fig1_both
    cands = [dict(), dict(mode="fused", fused_rows=2, fused_bc=8,
                          fused_bm=16)]
    jres = jtune.tune_join(jb, jp, candidates=[JPlan(**c) for c in cands])
    tres = ttune.tune_join(tb, tp, candidates=[EnginePlan(**c)
                                               for c in cands],
                           device="cpu")
    assert all(c.verified for c in jres.candidates)
    assert all(c.verified for c in tres.candidates)
    assert [c.peak_interface_bytes for c in tres.candidates] == \
        [c.peak_interface_bytes for c in jres.candidates] == [147456] * 2
    assert tres.bucket == jres.bucket == "M64-T32"
    assert tres.default.plan == EnginePlan()
    assert tres.winner.peak_interface_bytes <= \
        tres.default.peak_interface_bytes
    out = tdsc.run_dsc_lowerable(tb, tp, tres.winner.plan, device="cpu")
    for f in LABELS:
        assert _same(getattr(out.result, f), fig1_ref_labels[f]), f


def _tiny_cluster_instance(S=32, seed=0):
    """``tests/test_plan.py``'s instance as numpy arrays."""
    rng = np.random.default_rng(seed)
    raw = rng.uniform(0, 1, (S, S)).astype(np.float32)
    sim = np.maximum(raw, raw.T) * (rng.uniform(0, 1, (S, S)) > 0.7)
    np.fill_diagonal(sim, 0.0)
    sim = np.maximum(sim, sim.T).astype(np.float32)
    table = dict(t_start=np.zeros(S, np.float32),
                 t_end=np.ones(S, np.float32),
                 voting=rng.uniform(0, 5, S).astype(np.float32),
                 card=np.ones(S, np.int32), valid=np.ones(S, bool),
                 traj_row=np.arange(S, dtype=np.int32))
    return sim, table


def test_tune_cluster_tiles_matches_reference():
    """All six candidates verified against the plain oracle, bucket
    ``S32``; the port's oracle bitwise the reference's jnp engine."""
    sim, table = _tiny_cluster_instance()
    kw = dict(alpha_sigma=0.0, k_sigma=0.0)
    tsim_, ttable = torch.from_numpy(sim), SubtrajTable(
        **{k: torch.from_numpy(v) for k, v in table.items()})
    res = ttune.tune_cluster_tiles(tsim_, ttable, DSCParams(**kw),
                                   device="cpu")
    assert len(res.candidates) == 6
    assert all(c.verified for c in res.candidates)
    assert res.bucket == "S32"
    assert not res.candidates[0].plan.cluster_use_kernel
    assert all(c.plan.cluster_use_kernel for c in res.candidates[1:])
    assert all(c.peak_interface_bytes == 4 * 32 * 32
               for c in res.candidates)
    got = cluster_rounds(tsim_, ttable, DSCParams(**kw))
    want = jclust.cluster_rounds(
        jnp.asarray(sim), JTable(**{k: jnp.asarray(v)
                                    for k, v in table.items()}),
        JParams(**kw))
    for f in CLUSTER_FIELDS[:4]:
        assert _same(getattr(got, f), getattr(want, f)), f
    for f in CLUSTER_FIELDS[4:]:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   err_msg=f)


def _fig1_list(tb, tp):
    """fig1's flat contribution list (``scatter_operands`` of the port's
    materialize run) and its table."""
    out = tdsc.run_dsc(tb, tp, device="cpu")
    S = out.table.num_slots
    ms = tp.max_subtrajs_per_traj
    ops = tsim.scatter_operands(out.join, out.seg, out.seg.sub_local, S, ms)
    return ops, out.table


def test_tune_sim_panel_fig1_verifies_and_rejects_one_ulp(fig1_both,
                                                         monkeypatch):
    """Every panel height verified on fig1's list (it repeats cells, so the
    dense oracle's ordered scatter matters); a candidate whose lists carry
    one planted ulp is rejected."""
    _, tb, _, tp = fig1_both
    (src, dst, w), table = _fig1_list(tb, tp)
    S = table.num_slots
    res = ttune.tune_sim_panel(src, dst, w, table, tp, device="cpu")
    assert [c.plan.sim_panel for c in res.candidates] == [96, 32, 64, 192]
    assert all(c.verified for c in res.candidates)
    assert res.bucket == jtune.shape_bucket(S=S, K=32)
    assert int((src < S).sum()) > 0

    real = ttune.topk_stream

    def planted(panel_raw_fn, table, *, k, panel=None, **kw):
        out = real(panel_raw_fn, table, k=k, panel=panel, **kw)
        if panel == 64:
            out.sims[0, 0] = torch.nextafter(out.sims[0, 0],
                                             torch.tensor(2.0))
        return out

    monkeypatch.setattr(ttune, "topk_stream", planted)
    res = ttune.tune_sim_panel(src, dst, w, table, tp, device="cpu")
    bad = [c for c in res.candidates if not c.verified]
    assert [c.plan.sim_panel for c in bad] == [64]
    assert bad[0].note == "rejected: not bit-identical to the oracle"
    assert res.winner.plan.sim_panel != 64


def test_dense_raw_bitwise_reference_scatter():
    """A list with many repeated (src, dst) pairs and the sentinel S:
    the port's ordered scatter equals ``jnp.zeros(...).at[src, dst].add``
    bit for bit."""
    rng = np.random.default_rng(3)
    S, n = 12, 4000
    src = rng.integers(0, S + 1, n).astype(np.int32)
    dst = rng.integers(0, S + 1, n).astype(np.int32)
    w = (rng.uniform(0, 1, n) ** 3 * 10.0 ** rng.integers(-3, 3, n)) \
        .astype(np.float32)
    want = jnp.zeros((S + 1, S + 1), jnp.float32).at[src, dst].add(w)
    got = ttune._dense_raw(torch.from_numpy(src), torch.from_numpy(dst),
                           torch.from_numpy(w), S)
    assert _same(got, want)


def test_tune_pipeline_fig1_merged_plan(fig1_both, fig1_ref_labels,
                                        tmp_path):
    """The merged plan's labels are the reference's; its three winners
    land in a store that reloads and returns the stage winners."""
    _, tb, _, tp = fig1_both
    store = ttune.PlanStore(str(tmp_path / "plans.json"))
    tuned, results = ttune.tune_pipeline(tb, tp, store=store, device="cpu")
    assert set(results) == {"join", "cluster", "similarity"}
    assert all(c.verified for r in results.values() for c in r.candidates)
    assert [len(r.candidates) for r in results.values()] == [8, 6, 4]
    assert tuned.sim_panel == results["similarity"].winner.plan.sim_panel
    assert tuned.cluster_use_kernel == \
        results["cluster"].winner.plan.cluster_use_kernel
    store.save()
    again = ttune.PlanStore(str(tmp_path / "plans.json"))
    for stage, r in results.items():
        assert again.get(stage, r.bucket, backend="cpu") == r.winner.plan
    out = tdsc.run_dsc(tb, tp, plan=tuned, device="cpu")
    for f in LABELS:
        assert _same(getattr(out.result, f), fig1_ref_labels[f]), f


def test_tune_comm_on_a_cpu_mesh(fig1_both):
    """Mesh (2, 2) of four gloo ranks at fig1's size, one spawn: 4 of 4
    schedules verified against the barrier one, the ranks agreeing on the
    winner."""
    from repro_torch.core.partitioning import partition_batch
    from repro_torch.distributed.mesh import Mesh
    _, tb, _, tp = fig1_both
    parts = partition_batch(tb, 2)
    res = ttune.tune_comm(parts, tp, Mesh((2, 2), "gloo", "cpu"))
    assert len(res.candidates) == 4
    assert all(c.verified for c in res.candidates)
    assert res.bucket == jtune.shape_bucket(T=parts.x.shape[1], P=2, M=2)
    assert res.default.plan == EnginePlan()
    assert res.backend == "cpu"
