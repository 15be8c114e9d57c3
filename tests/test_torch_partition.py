"""PyTorch port: the partitioning rules (``repro_torch.distributed.
partition``), the production meshes (``repro_torch.launch.mesh``) and the
abstract inputs (``repro_torch.launch.input_specs``) held against the JAX
package's.

No subprocess and no rank: the rules take parameter trees and anything
with a ``.shape`` dict (a ``_FakeMesh``, as ``tests/test_partition.py``
uses), and the abstract inputs are ``device="meta"`` tensors, so the full
configurations cost no memory.  Everything compared here is exact: specs
as tuples (the port's ``PartitionSpec`` normalizes a one-name tuple as
JAX's does), byte counts, warnings, and every leaf's path, shape and
dtype.
"""
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.checkpoint import checkpointer as jck
from repro.configs import registry as jreg
from repro.distributed import partition as jpart
from repro.launch import input_specs as jin
from repro.launch import mesh as jmesh
from repro.models import transformer as jtf
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.configs import registry as treg
from repro_torch.distributed import partition as tpart
from repro_torch.distributed.mesh import Mesh
from repro_torch.launch import input_specs as tin
from repro_torch.launch import mesh as tmesh

ARCHS = jreg.ARCHITECTURES
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})
POLICIES = (("tp", False), ("tp", True), ("dp_only", False),
            ("dp_fsdp", False))


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _flat_j(tree):
    """path -> leaf of a reference tree (specs kept whole)."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))}


def _flat_t(tree, prefix=""):
    tree = tree.tree() if hasattr(tree, "tree") else tree
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_t(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _dt(dtype) -> str:
    return str(dtype).split(".")[-1]


@pytest.fixture(scope="module")
def params():
    """Every architecture's abstract params at ``ep_degree=16`` in both
    packages (the reference's ``jax.eval_shape``, the port's meta tree)."""
    out = {}
    for arch in ARCHS:
        jp = jax.eval_shape(lambda c=jreg.get_arch(arch): jtf.init_model(
            jax.random.PRNGKey(0), c, ep_degree=16))
        out[arch] = (jp, tin.abstract_params(treg.get_arch(arch),
                                             ep_degree=16))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, params):
    """``param_specs`` and ``report_sharding`` for every policy and
    ``fsdp`` on both production mesh shapes: equal spec for every path,
    equal byte counts; the meta tree's leaves have the reference's
    shapes and dtypes."""
    jp, tp = params[arch]
    jl, tl = _flat_j(jp), _flat_t(tp)
    assert set(tl) == set(jl)
    for path, leaf in jl.items():
        assert tuple(tl[path].shape) == leaf.shape, path
        assert _dt(tl[path].dtype) == _dt(leaf.dtype), path
        assert tl[path].device.type == "meta"
    jcfg, tcfg = jreg.get_arch(arch), treg.get_arch(arch)
    for shape in MESHES:
        mesh = _FakeMesh(shape)
        for policy, fsdp in POLICIES:
            js = jpart.param_specs(jp, jcfg, mesh, fsdp=fsdp, policy=policy)
            ts = tpart.param_specs(tp, tcfg, mesh, fsdp=fsdp, policy=policy)
            what = (arch, tuple(shape), policy, fsdp)
            want = {p: tuple(s) for p, s in _flat_j(js).items()}
            got = _flat_t(ts)
            assert all(isinstance(s, tpart.PartitionSpec)
                       for s in got.values())
            assert {p: tuple(s) for p, s in got.items()} == want, what
            assert tpart.report_sharding(tp, ts) == \
                jpart.report_sharding(jp, js), what


def _data_specs(mod, cfg, mesh, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        specs = mod.data_specs(cfg, mesh, **kw)
    return specs, [str(w.message) for w in caught]


def _as_tuples(specs):
    return {k: (_as_tuples(v) if isinstance(v, dict) else tuple(v))
            for k, v in specs.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_data_specs_match_reference(arch):
    """``data_specs`` for every shape kind of ``SHAPES`` (its batch and
    length, and a batch of 3 that divides no data-parallel degree), every
    policy, both mesh shapes: equal specs (the long-context sequence axis
    included) and equal warnings; ``batch_spec`` equal."""
    jcfg, tcfg = jreg.get_arch(arch), treg.get_arch(arch)
    for shape in MESHES + ({"data": 4},):
        mesh = _FakeMesh(shape)
        assert tuple(tpart.batch_spec(mesh)) == \
            tuple(jpart.batch_spec(mesh))
        for sh in jreg.SHAPES.values():
            for B in (sh["global_batch"], 3):
                for policy in ("tp", "dp_only", "dp_fsdp"):
                    kw = dict(kind=sh["kind"], global_batch=B,
                              seq_len=sh["seq_len"], policy=policy)
                    want, wwarn = _data_specs(jpart, jcfg, mesh, **kw)
                    got, gwarn = _data_specs(tpart, tcfg, mesh, **kw)
                    assert _as_tuples(got) == _as_tuples(want), (shape, kw)
                    assert gwarn == wwarn, (shape, kw)


def test_replicated_batch_warns_and_long_context():
    """A batch that divides no data-parallel degree warns (and is
    replicated); B = 1 does not warn and shards the cache's sequence
    over 'data' (``long_500k``)."""
    cfg = treg.get_arch("gemma2-2b")
    mesh = _FakeMesh({"data": 16, "model": 16})
    with pytest.warns(UserWarning, match="REPLICATED"):
        specs = tpart.data_specs(cfg, mesh, kind="train", global_batch=24,
                                 seq_len=4096)
    assert tuple(specs["tokens"]) == (None, None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        specs = tpart.data_specs(cfg, mesh, kind="decode", global_batch=1,
                                 seq_len=524_288)
    assert specs["cache"]["k"][2] == "data" and specs["cache"]["k"][3] is None


def test_partition_spec_and_local_block():
    """The spec normalizes as JAX's; ``named`` / ``local_block`` give each
    rank its block (a tuple entry row-major over its axes); a dimension
    that does not divide raises."""
    for parts in ((("data",), None), ((), "model"), (("pod", "data"),)):
        assert tuple(tpart.P(*parts)) == tuple(JP(*parts))

    class _Rank:
        coords = {"pod": 1, "data": 2, "model": 0}
        shape = {"pod": 2, "data": 4, "model": 2}

        def axis_size(self, e):
            names = (e,) if isinstance(e, str) else e
            return int(np.prod([self.shape[a] for a in names]))

        def axis_index(self, e):
            names = (e,) if isinstance(e, str) else e
            i = 0
            for a in names:
                i = i * self.shape[a] + self.coords[a]
            return i

    x = torch.arange(16 * 6).reshape(16, 6)
    sh = tpart.named(None, {"w": tpart.P(("pod", "data"), "model")})["w"]
    blk = sh.local_block(x, _Rank())
    assert torch.equal(blk, x[12:14, 0:3])        # block 1 * 4 + 2 = 6 of 8
    with pytest.raises(ValueError, match="divide"):
        tpart.local_block(torch.zeros(3, 2), tpart.P("data"), _Rank())


def test_launch_meshes_match_reference(monkeypatch):
    """The production meshes' shapes and axis names are the reference's
    (its ``jax.make_mesh`` calls recorded: 256 devices are not here);
    each is a ``Mesh`` description on nccl, never spawned on one card;
    ``dp_axes_of`` equal."""
    calls = []
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shape, axes: calls.append((shape, axes))
                        or _FakeMesh(dict(zip(axes, shape))))
    pairs = ((jmesh.make_production_mesh(), tmesh.make_production_mesh()),
             (jmesh.make_production_mesh(multi_pod=True),
              tmesh.make_production_mesh(multi_pod=True)),
             (jmesh.make_dsc_mesh(), tmesh.make_dsc_mesh()),
             (jmesh.make_dsc_mesh(multi_pod=True, model=8),
              tmesh.make_dsc_mesh(multi_pod=True, model=8)),
             (jmesh.make_test_mesh(), tmesh.make_test_mesh()),
             (jmesh.make_test_mesh(2, 1), tmesh.make_test_mesh(2, 1)))
    for (shape, axes), (jm, tm) in zip(calls, pairs):
        assert isinstance(tm, Mesh) and tm.comm == "nccl"
        assert (tm.sizes, tm.axis_names) == (tuple(shape), tuple(axes))
        assert tm.shape == jm.shape
        assert tmesh.dp_axes_of(tm) == jmesh.dp_axes_of(jm)
    assert tmesh.make_production_mesh(multi_pod=True).size == 512


def test_mesh_of_three_axes():
    """Meshes of one to three named axes, row-major as ``jax.make_mesh``
    lays out its devices; names and sizes are checked."""
    m = Mesh((2, 3, 4), "gloo", "cpu", ("pod", "data", "model"))
    assert m.size == 24 and m.shape == {"pod": 2, "data": 3, "model": 4}
    order = np.arange(24).reshape(2, 3, 4)
    for r in range(24):
        c = m.coords(r)
        assert order[c["pod"], c["data"], c["model"]] == r
        assert m.rank_of(c) == r
    assert Mesh((4,), "gloo", "cpu", ("pod",)).coords(3) == {"pod": 3}
    with pytest.raises(ValueError, match="axis_names"):
        Mesh((2, 2, 2), "gloo", "cpu")
    with pytest.raises(ValueError, match="axis_names"):
        Mesh((2, 2), "gloo", "cpu", ("data", "data"))
    with pytest.raises(ValueError, match="sizes"):
        Mesh((2, 2, 2, 2), "gloo", "cpu", ("a", "b", "c", "d"))


def _meta_close(got, want, what):
    assert tuple(got.shape) == tuple(want.shape), what
    assert _dt(got.dtype) == _dt(want.dtype), what
    assert got.device.type == "meta", what


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """``input_specs`` for every shape the registry allows the
    architecture (keys, the cache's leaves, shapes and dtypes), and
    ``abstract_train_state`` at ``ep_degree`` 1 and 16: every leaf's path,
    shape and dtype equal to the reference's ``jax.eval_shape``."""
    jcfg = jreg.get_arch(arch)
    for shape in jreg.SHAPES:
        if not jreg.shape_applicable(jcfg, shape)[0]:
            continue
        want = jin.input_specs(arch, shape)
        got = tin.input_specs(arch, shape)
        assert got.keys() == want.keys(), shape
        assert got["cfg"] == treg.get_arch(arch)
        for k in ("kind", "batch", "seq"):
            assert got[k] == want[k]
        for k in set(want) - {"cfg", "kind", "batch", "seq", "cache"}:
            _meta_close(got[k], want[k], (shape, k))
        if "cache" in want:
            assert got["cache"].keys() == want["cache"].keys()
            for k, v in want["cache"].items():
                _meta_close(got["cache"][k], v, (shape, "cache", k))
    for ep in (1, 16):
        js = jin.abstract_train_state(jcfg, ep_degree=ep)
        ts = tin.abstract_train_state(treg.get_arch(arch), ep_degree=ep)
        jpaths, jleaves, _ = jck._flatten_with_paths(js)
        tpaths, tleaves = tck._flatten_with_paths(ts)
        assert tpaths == jpaths
        for p, g, w in zip(jpaths, tleaves, jleaves):
            _meta_close(g, w, (ep, p))
