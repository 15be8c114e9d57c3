"""PyTorch port: the multi-device DSC program (``repro_torch.core.
distributed`` over ``repro_torch.distributed.mesh``) held against the JAX
package's ``shard_map`` program.

The reference runs once, in one subprocess with
``--xla_force_host_platform_device_count=4`` (as ``test_distributed.py``
runs it), every case of ``CASES`` and the collectives' cases, and writes
its arrays to an ``.npz``.  Meanwhile the port runs the same cases on
gloo CPU ranks, one ``spawn`` per mesh shape, each rank running all of
that shape's cases with one thread.  Both read the same numpy batches
(the port's generators are the reference's draw for draw).

What must agree, and how closely:

* labels (``member_of``, ``is_rep``, ``is_outlier``), ``active``, the
  table's ``t_start``, ``t_end``, ``card``, ``valid`` and ``traj_row``,
  and the top-K overflow counts (``sim_diag[:, 3]``): equal;
* ``vote`` and the table's ``voting``: 1e-5 absolute (measured at most
  5.7e-6 and 3.8e-6).  The port sums a point's best-match weights in
  PyTorch's order (and XLA contracts the join's ``dx*dx + dy*dy`` into
  an FMA), as on one device (``test_torch_dsc.py``);
* ``member_sim`` and ``sim_diag[:, :3]`` (mean similarity, alpha, k):
  1e-5 relative (measured at most 1.2e-7 and 3.2e-6 absolute).  The
  similarity cells add the same weights in another order than XLA's
  scatter, and alpha / k / the mean reduce vectors in another order
  (ROADMAP Queue 3's ulp-level sums);
* the collectives against ``lax.ppermute`` / ``all_gather`` /
  ``all_to_all`` / ``psum`` / ``pmean`` under ``shard_map``: bitwise,
  except ``psum`` / ``pmean`` over 4 ranks, 1e-6 relative (the port sums
  in rank order; XLA's order over 4 devices is its own);
* within the port: the stage chain equals the monolith bit for bit, every
  rank returns the same output, the ring twins equal their barrier twins
  bitwise, and P = 1 gives the labels of the port's ``run_dsc``.

The reference's fused dense ``psum`` run is wrong at more than one model
rank (``repro/core/distributed.py:643`` passes the unsliced candidate
slot map; ROADMAP Queue 3), so the port's fused ``psum`` case is held
against the reference's materialize run.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.types import DSCParams, TrajectoryBatch
from repro_torch.data import synthetic as tsyn

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LABELS = ("member_of", "is_rep", "is_outlier")
TABLE_EQ = ("t_start", "t_end", "card", "valid", "traj_row")
FIG1 = dict(eps_sp=0.42, eps_t=1.0, delta_t=0.0, w=6, tau=0.15,
            alpha_sigma=-1.0, k_sigma=-1.0)
TOPK = dict(sim_mode="topk", sim_topk=48)
KERNELS = dict(use_kernel=True, seg_use_kernel=True, cluster_use_kernel=True)
RINGS = dict(halo_stream="ring", sim_exchange="ring")

# name -> (mesh, scenario, plan keywords, on_overflow, the reference case
# it is held against)
CASES = {
    "mat_psum": ((2, 2), "fig1_tsa2", {}, "raise", None),
    "mat_allgather": ((2, 2), "fig1_tsa2", dict(sim_strategy="allgather"),
                      "raise", None),
    "fused_allgather": ((2, 2), "fig1_tsa2",
                        dict(mode="fused", sim_strategy="allgather"),
                        "raise", None),
    "fused_psum": ((2, 2), "fig1_tsa2", dict(mode="fused"), "raise",
                   "mat_psum"),
    "topk_mat": ((2, 2), "fig1_tsa2", TOPK, "raise", None),
    "topk_fused": ((2, 2), "fig1_tsa2", dict(TOPK, mode="fused"), "raise",
                   None),
    "ring_mat": ((2, 2), "fig1_tsa2", dict(RINGS, sim_strategy="allgather"),
                 "raise", None),
    "ring_topk": ((2, 2), "fig1_tsa2", dict(TOPK, **RINGS), "raise", None),
    "ring_fused": ((2, 2), "fig1_tsa2",
                   dict(RINGS, mode="fused", sim_strategy="allgather"),
                   "raise", None),
    "bf16_psum": ((2, 2), "fig1_tsa2", dict(sim_dtype="bf16"), "raise",
                  None),
    "bf16_allgather": ((2, 2), "fig1_tsa2",
                       dict(sim_dtype="bf16", sim_strategy="allgather"),
                       "raise", None),
    "index": ((2, 2), "fig1_tsa2", dict(use_index=True), "raise", None),
    "kernels_index": ((2, 2), "fig1_tsa2", dict(KERNELS, use_index=True),
                      "raise", None),
    "sequential": ((2, 2), "fig1_tsa2", dict(cluster_engine="sequential"),
                   "raise", None),
    "tsa1": ((2, 2), "fig1_tsa1", {}, "raise", None),
    "tsa1_fused_topk": ((2, 2), "fig1_tsa1", dict(TOPK, mode="fused"),
                        "raise", None),
    "overflow_raise": ((2, 2), "fig1_tsa2", dict(sim_mode="topk",
                                                 sim_topk=2), "raise", None),
    "overflow_widen": ((2, 2), "fig1_tsa2", dict(sim_mode="topk",
                                                 sim_topk=2), "widen", None),
    "overflow_degrade": ((2, 2), "fig1_tsa2", dict(sim_mode="topk",
                                                   sim_topk=2), "degrade",
                         None),
    "ais": ((2, 2), "ais", dict(mode="fused", sim_strategy="allgather"),
            "raise", None),
    "p4_mat": ((4, 1), "fig1_tsa2", {}, "raise", None),
    "p4_fused_psum": ((4, 1), "fig1_tsa2", dict(mode="fused"), "raise",
                      None),
    "p4_topk_ring": ((4, 1), "fig1_tsa2", dict(TOPK, **RINGS, mode="fused"),
                     "raise", None),
    "p1_mat": ((1, 2), "fig1_tsa2", {}, "raise", None),
    "p1_fused_topk": ((1, 2), "fig1_tsa2", dict(TOPK, mode="fused"),
                      "raise", None),
}
# ring twin -> barrier twin (within the port, bitwise)
RING_TWINS = {"ring_mat": "mat_allgather", "ring_topk": "topk_mat",
              "ring_fused": "fused_allgather"}
# the stage chains run on the (2, 2) mesh, each against its monolith case
CHAINS = {"chain_mat": "mat_psum", "chain_fused_topk": "topk_fused"}
# build_dsc_program's body, called on the (2, 2) ranks -> its monolith case
BODIES = {"body_mat": "mat_psum", "body_fused": "fused_allgather"}
# psum case -> allgather case: one column-block gather, the same bits
STRATEGY_TWINS = {"mat_psum": "mat_allgather",
                  "fused_psum": "fused_allgather",
                  "bf16_psum": "bf16_allgather"}
MESHES = sorted({c[0] for c in CASES.values()})


def _scenarios():
    """name -> (numpy batch arrays, DSCParams keywords)."""
    fig1 = tsyn.figure1_scenario(n_per_route=4, points_per_leg=24, seed=0,
                                 device="cpu")[0]
    ais = tsyn.ais_like(n_vessels=24, max_points=96, seed=1, device="cpu")[0]
    diam, mean_dt = tsyn.default_dsc_params_for(ais)
    arrays = lambda b: {f: getattr(b, f).numpy()
                        for f in ("x", "y", "t", "valid", "traj_id")}
    return {
        "fig1_tsa2": (arrays(fig1), dict(FIG1, segmentation="tsa2")),
        "fig1_tsa1": (arrays(fig1), dict(FIG1, segmentation="tsa1")),
        "ais": (arrays(ais), dict(eps_sp=0.15 * diam, eps_t=mean_dt,
                                  delta_t=0.0, w=12, tau=0.4,
                                  alpha_sigma=-1.0, k_sigma=-1.0,
                                  segmentation="tsa2")),
    }


def _collective_inputs(P, M):
    """Per-rank inputs ``[P, M, n, 3, 4]`` (n = P, the part axis size) and
    ``[P, M, 5]`` for the reductions."""
    rng = np.random.default_rng(P * 10 + M)
    return (rng.uniform(-1, 1, (P, M, P, 3, 4)).astype(np.float32),
            rng.uniform(-1, 1, (P, M, 5)).astype(np.float32))


_REFERENCE_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import numpy as np
    import jax
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from repro.core.distributed import run_dsc_distributed
    from repro.core.partitioning import partition_batch
    from repro.core.types import DSCParams, TrajectoryBatch
    from repro.utils.compat import shard_map

    spec = json.load(open(sys.argv[1]))
    data = np.load(sys.argv[2])
    out, errors = {}, {}
    for name, (mesh_shape, scen, plan, on_overflow) in spec["cases"].items():
        mesh = jax.make_mesh(tuple(mesh_shape), ("part", "model"))
        batch = TrajectoryBatch(*(data[f"{scen}/{f}"] for f in
                                  ("x", "y", "t", "valid", "traj_id")))
        params = DSCParams(**spec["params"][scen])
        parts = partition_batch(batch, mesh_shape[0])
        try:
            o = run_dsc_distributed(parts, params, mesh,
                                    on_overflow=on_overflow, **plan)
        except RuntimeError as e:
            errors[name] = str(e)
            continue
        for f in ("member_of", "member_sim", "is_rep", "is_outlier"):
            out[f"{name}/{f}"] = np.asarray(getattr(o.result, f))
        for f in ("t_start", "t_end", "voting", "card", "valid",
                  "traj_row"):
            out[f"{name}/table.{f}"] = np.asarray(getattr(o.table, f))
        for f in ("vote", "active", "sim_diag"):
            out[f"{name}/{f}"] = np.asarray(getattr(o, f))

    # the collectives under shard_map, per rank, stacked [P, M, ...]
    for Pn, Mn in spec["collective_meshes"]:
        mesh = jax.make_mesh((Pn, Mn), ("part", "model"))
        x, v = data[f"coll/{Pn}x{Mn}/x"], data[f"coll/{Pn}x{Mn}/v"]
        ops = {
            "pp_part_fwd": lambda x, v: lax.ppermute(
                x, "part", [(i, i + 1) for i in range(Pn - 1)]),
            "pp_part_back": lambda x, v: lax.ppermute(
                x, "part", [(i, i - 1) for i in range(1, Pn)]),
            "pp_part_ring": lambda x, v: lax.ppermute(
                x, "part", [(i, (i + 1) % Pn) for i in range(Pn)]),
            "pp_model_swap": lambda x, v: lax.ppermute(
                x, "model", [(i, (i + 1) % Mn) for i in range(Mn)]),
            "ag_part": lambda x, v: lax.all_gather(x, "part"),
            "ag_model": lambda x, v: lax.all_gather(v, "model"),
            "a2a_s0c1": lambda x, v: lax.all_to_all(x, "part", 0, 1),
            "a2a_s1c0": lambda x, v: lax.all_to_all(
                x.transpose(1, 0, 2), "part", 1, 0),
            "a2a_s0c2": lambda x, v: lax.all_to_all(x, "part", 0, 2),
            "psum_part": lambda x, v: lax.psum(v, "part"),
            "pmean_part": lambda x, v: lax.pmean(v, "part"),
            "psum_model": lambda x, v: lax.psum(v, "model"),
        }
        for op, fn in ops.items():
            body = lambda x, v, fn=fn: fn(x[0, 0], v[0, 0])[None, None]
            prog = shard_map(body, mesh=mesh,
                             in_specs=(P("part", "model"),
                                       P("part", "model")),
                             out_specs=P("part", "model"))
            out[f"coll/{Pn}x{Mn}/{op}"] = np.asarray(jax.jit(prog)(x, v))
    np.savez(sys.argv[3], **out)
    json.dump(errors, open(sys.argv[4], "w"))
""")

COLLECTIVE_OPS = ("pp_part_fwd", "pp_part_back", "pp_part_ring",
                  "pp_model_swap", "ag_part", "ag_model", "a2a_s0c1",
                  "a2a_s1c0", "a2a_s0c2", "psum_part", "pmean_part",
                  "psum_model")


def _collectives(comm, x, v):
    """The port's side of ``COLLECTIVE_OPS`` on this rank's inputs."""
    Pn, Mn = comm.axis_size("part"), comm.axis_size("model")
    ops = {
        "pp_part_fwd": lambda: comm.ppermute(
            x, "part", [(i, i + 1) for i in range(Pn - 1)]),
        "pp_part_back": lambda: comm.ppermute(
            x, "part", [(i, i - 1) for i in range(1, Pn)]),
        "pp_part_ring": lambda: comm.ppermute(
            x, "part", [(i, (i + 1) % Pn) for i in range(Pn)]),
        "pp_model_swap": lambda: comm.ppermute(
            x, "model", [(i, (i + 1) % Mn) for i in range(Mn)]),
        "ag_part": lambda: comm.all_gather(x, "part"),
        "ag_model": lambda: comm.all_gather(v, "model"),
        "a2a_s0c1": lambda: comm.all_to_all(x, "part", 0, 1),
        "a2a_s1c0": lambda: comm.all_to_all(x.transpose(0, 1), "part", 1,
                                            0),
        "a2a_s0c2": lambda: comm.all_to_all(x, "part", 0, 2),
        "psum_part": lambda: comm.psum(v, "part"),
        "pmean_part": lambda: comm.pmean(v, "part"),
        "psum_model": lambda: comm.psum(v, "model"),
    }
    comm.reset_stats()
    got = {}
    for op, fn in ops.items():
        comm.phase = op
        got[op] = fn()
    return got, dict(comm.stats)


def _fields(o):
    """A ``DistributedDSCOutput`` as ``{field: tensor}`` (the names the
    reference script writes)."""
    d = {f: getattr(o.result, f) for f in LABELS + ("member_sim",
                                                   "alpha_used", "k_used")}
    for f in ("t_start", "t_end", "voting", "card", "valid", "traj_row"):
        d[f"table.{f}"] = getattr(o.table, f)
    d.update(vote=o.vote, active=o.active, sim_diag=o.sim_diag)
    return d


def _chain(parts, params, mesh, plan):
    """The five stage functions in order: the monolith's output."""
    from repro_torch.core.distributed import (DistributedDSCOutput,
                                              build_dsc_stage_programs)
    from repro_torch.core.types import ClusteringResult
    st = build_dsc_stage_programs(parts, params, mesh, plan=plan)
    pts = (parts.x, parts.y, parts.t, parts.valid, parts.traj_id,
           parts.ranges)
    j = st["join"](*pts)
    table, labels = st["segment"](parts.t, parts.valid, j[0], j[1])
    sim = st["similarity"](*pts, labels, table, *j[2:])
    c = st["cluster"](table, sim[-1], *sim[:-1])
    final = st["refine"](c[0], c[1], c[2], sim[-1], c[4], c[5])
    assert isinstance(final, ClusteringResult)
    return DistributedDSCOutput(result=final, table=table, vote=j[0],
                                active=sim[-1], sim_diag=c[6])


def _body(parts, params, mesh, plan):
    """``build_dsc_program``'s body on this rank, then its two halves
    (``body.back(body.front(...))``): two outputs."""
    from repro_torch.core.distributed import (DistributedDSCOutput,
                                              build_dsc_program)
    body = build_dsc_program(parts, params, mesh, plan=plan)
    pts = (parts.x, parts.y, parts.t, parts.valid, parts.traj_id,
           parts.ranges)
    outs = []
    for final, table, vote, active, diag in (
            body(*pts), body.back(body.front(*pts))):
        outs.append(_fields(DistributedDSCOutput(
            result=final, table=table, vote=vote, active=active,
            sim_diag=diag)))
    return outs


def _port_mesh(sizes, scenarios, coll):
    """One rank of a ``sizes`` mesh: every case of that shape, the
    collectives, the stage chains (2 x 2) and P = 1 against ``run_dsc``."""
    from repro_torch.core.distributed import run_dsc_distributed
    from repro_torch.core.dsc import run_dsc
    from repro_torch.core.partitioning import partition_batch
    from repro_torch.core.plan import EnginePlan
    from repro_torch.distributed.mesh import Mesh, current
    mesh = Mesh(sizes, "gloo", "cpu")
    comm = current()
    out, errors = {}, {}

    def data(scen):
        arrays, kw = scenarios[scen]
        batch = TrajectoryBatch.from_arrays(*arrays.values(), device="cpu")
        return batch, DSCParams(**kw)

    for name, (shape, scen, plan, on_overflow, _) in CASES.items():
        if shape != sizes:
            continue
        batch, params = data(scen)
        parts = partition_batch(batch, sizes[0])
        try:
            o = run_dsc_distributed(parts, params, mesh,
                                    on_overflow=on_overflow, **plan)
        except RuntimeError as e:
            errors[name] = str(e)
            continue
        out[name] = _fields(o)
        if name == "p1_mat":
            single = run_dsc(batch, params, device="cpu")
            out["p1_single"] = {f: getattr(single.result, f)
                                for f in LABELS}
    if sizes == (2, 2):
        batch, params = data("fig1_tsa2")
        parts = partition_batch(batch, 2)
        for name, case in CHAINS.items():
            plan = EnginePlan.from_legacy(**CASES[case][2])
            out[name] = _fields(_chain(parts, params, mesh, plan))
        for name, case in BODIES.items():
            plan = EnginePlan.from_legacy(**CASES[case][2])
            out[name], out[name + "_halves"] = _body(parts, params, mesh,
                                                     plan)
    if sizes in coll:
        x, v = (torch.from_numpy(a[comm.axis_index("part"),
                                   comm.axis_index("model")])
                for a in coll[sizes])
        out["coll"], out["coll_stats"] = _collectives(comm, x, v)
    return out, errors


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(ref arrays, ref errors, port per mesh: [per-rank (out,
    errors)])``: the reference's subprocess runs while the port's ranks
    do."""
    from repro_torch.distributed.mesh import Mesh, spawn
    tmp = tmp_path_factory.mktemp("dist")
    scenarios = _scenarios()
    coll = {m: _collective_inputs(*m) for m in ((2, 2), (4, 1))}
    arrays = {f"{s}/{f}": a for s, (arr, _) in scenarios.items()
              for f, a in arr.items()}
    for (Pn, Mn), (x, v) in coll.items():
        arrays[f"coll/{Pn}x{Mn}/x"], arrays[f"coll/{Pn}x{Mn}/v"] = x, v
    np.savez(tmp / "data.npz", **arrays)
    spec = {"cases": {n: (c[0], c[1], c[2], c[3]) for n, c in CASES.items()},
            "params": {s: kw for s, (_, kw) in scenarios.items()},
            "collective_meshes": list(coll)}
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_SCRIPT, str(tmp / "spec.json"),
         str(tmp / "data.npz"), str(tmp / "ref.npz"),
         str(tmp / "errors.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = {m: spawn(_port_mesh, Mesh(m, "gloo", "cpu"), m, scenarios,
                         coll, threads=1, timeout=600) for m in MESHES}
        _, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    got = dict(np.load(tmp / "ref.npz"))
    return got, json.loads((tmp / "errors.json").read_text()), port


def _close(name, got, want, f):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (name, f)
    if f in LABELS + ("active",) or f[6:] in TABLE_EQ:
        assert np.array_equal(got, want), (name, f)
    elif f in ("vote", "table.voting"):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=f"{name} {f}")
    elif f == "sim_diag":
        assert np.array_equal(got[:, 3], want[:, 3]), (name, f)
        np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=1e-5,
                                   err_msg=f"{name} {f}")
    else:                                           # member_sim
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   err_msg=f"{name} {f}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_program_matches_reference(runs, name):
    """Every case: the port's output on rank 0 against the reference's
    (or, for the fused ``psum`` case at two model ranks, against the
    reference's materialize run), and every rank's output equal."""
    ref, ref_errors, port = runs
    shape, _, _, _, against = CASES[name]
    ranks = port[shape]
    if name == "overflow_raise":
        assert name in ref_errors
        for _, errors in ranks:
            assert errors[name] == ref_errors[name]
        return
    assert name not in ref_errors, ref_errors.get(name)
    want = against or name
    got = ranks[0][0][name]
    for f, t in got.items():
        if f in ("alpha_used", "k_used"):
            continue
        _close(name, t, ref[f"{want}/{f}"], f)
    for out, _ in ranks[1:]:
        for f, t in got.items():
            assert torch.equal(out[name][f], t), (name, f)
    if name == "overflow_widen":
        assert int(got["sim_diag"][:, 3].sum()) == 0
    if name == "overflow_degrade":
        assert int(got["sim_diag"][:, 3].sum()) > 0


def test_fused_psum_reference_fault_is_real(runs):
    """The reference's own fused ``psum`` run at (2, 2) disagrees with its
    materialize run (the fault the port does not copy); the port's equals
    it (``test_program_matches_reference[fused_psum]``)."""
    ref, _, port = runs
    assert not all(np.array_equal(ref[f"fused_psum/{f}"],
                                  ref[f"mat_psum/{f}"]) for f in LABELS)
    assert all(np.array_equal(ref[f"fused_allgather/{f}"],
                              ref[f"mat_psum/{f}"]) for f in LABELS)


@pytest.mark.parametrize("ring", sorted(RING_TWINS))
def test_ring_twins_bitwise(runs, ring):
    got = runs[2][(2, 2)][0][0]
    for f, t in got[ring].items():
        assert torch.equal(t, got[RING_TWINS[ring]][f]), (ring, f)


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_stage_chain_equals_monolith(runs, chain):
    """The stage functions in sequence give the monolith's outputs bit for
    bit, on every rank."""
    for out, _ in runs[2][(2, 2)]:
        for f, t in out[chain].items():
            mono = out[CHAINS[chain]][f]
            assert t.dtype == mono.dtype and torch.equal(t, mono), (chain, f)


@pytest.mark.parametrize("body", sorted(BODIES))
def test_program_body_equals_run(runs, body):
    """``build_dsc_program``'s body, called on each rank, and its front
    and back halves give ``run_dsc_distributed``'s outputs bit for bit."""
    for out, _ in runs[2][(2, 2)]:
        for got in (out[body], out[body + "_halves"]):
            for f, t in got.items():
                run = out[BODIES[body]][f]
                assert t.dtype == run.dtype and torch.equal(t, run), (body,
                                                                       f)


@pytest.mark.parametrize("case", sorted(STRATEGY_TWINS))
def test_sim_strategies_bitwise(runs, case):
    """The dense ``psum`` and ``allgather`` strategies give the same bits
    (the reference's psum of zero-padded column blocks is their
    concatenation)."""
    got = runs[2][(2, 2)][0][0]
    for f, t in got[case].items():
        assert torch.equal(t, got[STRATEGY_TWINS[case]][f]), (case, f)


def test_p1_matches_single_device(runs):
    """P = 1 (one partition, two model ranks) gives the labels of the
    port's one-device ``run_dsc``."""
    out = runs[2][(1, 2)][0][0]
    for f in LABELS:
        assert torch.equal(out["p1_mat"][f], out["p1_single"][f]), f


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
@pytest.mark.parametrize("op", COLLECTIVE_OPS)
def test_collective_matches_lax(runs, op, shape):
    ref, _, port = runs
    want = ref[f"coll/{shape[0]}x{shape[1]}/{op}"]
    got = np.stack([out["coll"][op].numpy() for out, _ in port[shape]])
    got = got.reshape(want.shape)
    if op.startswith("p") and op[1:4] in ("sum", "mea") and shape[0] > 2 \
            and op.endswith("part"):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        assert np.array_equal(got, want), op
    if op == "pp_part_fwd":       # the edge rank receives zeros
        assert not got[0].any()


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_collective_stats(runs, shape):
    """Each collective adds one call and the bytes this rank sent to
    ``MeshComm.stats`` under its phase: an ``all_gather`` its payload, an
    ``all_to_all`` the chunks for the other ranks, a ``ppermute`` its
    payload where it sends (the last rank of a forward shift sends
    nothing); ``psum`` is recorded as its ``all_gather``."""
    n = shape[0]
    for rank, (out, _) in enumerate(runs[2][shape]):
        st, got = out["coll_stats"], out["coll"]
        nbytes = got["ag_part"][0].numel() * got["ag_part"].element_size()
        assert st["ag_part.all_gather.part"][:2] == [1, nbytes]
        assert st["a2a_s0c1.all_to_all.part"][:2] == [1,
                                                      nbytes * (n - 1) // n]
        last = rank // shape[1] == n - 1
        assert st["pp_part_fwd.ppermute.part"][:2] == [1,
                                                       0 if last else nbytes]
        assert st["psum_part.all_gather.part"][0] == 1
        assert all(row[2] >= 0.0 for row in st.values())


def _fail_on_rank_one():
    from repro_torch.distributed.mesh import current
    comm = current()
    if comm.rank == 1:
        raise ValueError("rank one fails")
    comm.all_gather(torch.zeros(1), "part")     # waits for rank 1
    return comm.rank


def test_spawn_fails_with_a_failing_rank():
    """A rank that raises makes ``spawn`` raise with its traceback; the
    rank left waiting in a collective is ended."""
    from repro_torch.distributed.mesh import Mesh, spawn
    with pytest.raises(RuntimeError, match="mesh rank 1 failed"):
        spawn(_fail_on_rank_one, Mesh((2, 1), "gloo", "cpu"), threads=1,
              timeout=120)


def test_mesh_arguments():
    """The transport is explicit and checked; ``shape`` maps the axis
    names to their sizes, as a JAX mesh's does."""
    from repro_torch.distributed.mesh import Mesh
    mesh = Mesh((4, 2), "gloo", "cpu")
    assert mesh.shape == {"part": 4, "model": 2} and mesh.size == 8
    with pytest.raises(ValueError, match="comm="):
        Mesh((2, 2), "mpi", "cpu")
    with pytest.raises(ValueError, match="nccl"):
        Mesh((2, 2), "nccl", "cpu")
    with pytest.raises(ValueError, match="sizes"):
        Mesh((0, 2), "gloo", "cpu")
