"""PyTorch port: GPipe pipeline parallelism (``repro_torch.distributed.
pipeline``) held against the JAX package's ``pipeline_apply``.

The reference's stage function and sizes (``tests/test_pipeline.py``:
S = 4 stages of ``tanh(x @ W)``, D = 16, B = 8, four microbatches) on the
mesh (pod, data) = (4, 2).  The reference runs once, in one subprocess
with ``--xla_force_host_platform_device_count=8``, under ``jax.jit``: its
own test calls the ``shard_map`` eagerly, which jax 0.9 refuses ("Please
enter your `jit` into a mesh context via `jax.set_mesh`"; ROADMAP Queue
3), so the subprocess also records that refusal.  The port runs the same
on eight gloo CPU ranks (one ``spawn``), every rank passing the same
global arguments.

What must agree, and how closely (f32 throughout):

* the forward: within ``FWD_TOL`` of ``jax.jit(fn)``'s (the reference's
  own test allows 1e-5 against the sequential composition; XLA's dot
  sums in its own order);
* the gradient of sum(y**2) with respect to the stacked stage weights:
  within ``GRAD_REL`` relative L2 of ``jax.grad``'s;
* within the port: the forward bitwise equal to the sequential
  composition of the same stages over the same microbatches, the
  gradient within ``GRAD_REL`` of autograd through that composition, and
  every rank's bits equal;
* ``bubble_fraction(4, 4) == 3/7``.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
S, D, B, N_MICRO = 4, 16, 8, 4
FWD_TOL = 1e-6
GRAD_REL = 1e-5

_REFERENCE_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.distributed.pipeline import pipeline_apply

    data, out_path = sys.argv[1:3]
    arrs = dict(np.load(data))
    Ws, x = jnp.asarray(arrs["Ws"]), jnp.asarray(arrs["x"])
    out = {}
    mesh = jax.make_mesh((4, 2), ("pod", "data"),
                         axis_types=(AxisType.Auto,) * 2)

    def stage_fn(W, xb):
        return jnp.tanh(xb @ W)

    fn = pipeline_apply(stage_fn, mesh, stage_axis="pod", n_micro=4,
                        data_axes=("data",))
    try:                    # the reference's own test: default axes, eager
        fn0 = pipeline_apply(stage_fn, jax.make_mesh((4, 2), ("pod", "data")),
                             stage_axis="pod", n_micro=4, data_axes=("data",))
        fn0(Ws, x)
        jax.grad(lambda W: jnp.sum(fn0(W, x) ** 2))(Ws)
        out["eager_error"] = np.asarray("")
    except Exception as e:
        out["eager_error"] = np.asarray(str(e)[:300])
    with mesh:
        out["y"] = np.asarray(jax.jit(fn)(Ws, x))
        out["g"] = np.asarray(jax.jit(jax.grad(
            lambda W: jnp.sum(fn(W, x) ** 2)))(Ws))
    np.savez(out_path, **out)
""")


def _stage(W, xb):
    return torch.tanh(xb @ W)


def _port_rank(Ws, x):
    from repro_torch.distributed.mesh import Mesh, current
    from repro_torch.distributed.pipeline import pipeline_apply
    mesh = Mesh((4, 2), "gloo", "cpu", ("pod", "data"))
    fn = pipeline_apply(_stage, mesh, stage_axis="pod", n_micro=N_MICRO,
                        data_axes=("data",))
    with torch.no_grad():
        y = fn(Ws, x)
    W = Ws.clone().requires_grad_()
    g, = torch.autograd.grad((fn(W, x) ** 2).sum(), W)
    out = {"y": y, "g": g, "comms": _comms_kept(mesh)}
    if current().rank == 0:
        # the sequential composition of the same stages over the same
        # microbatches (each data shard's batch cut in N_MICRO)
        def seq(W):
            outs = []
            for mb in x.reshape(2 * N_MICRO, -1, D):
                for s in range(S):
                    mb = _stage(W[s], mb)
                outs.append(mb)
            return torch.cat(outs)
        with torch.no_grad():
            out["seq_y"] = seq(Ws)
        W = Ws.clone().requires_grad_()
        out["seq_g"], = torch.autograd.grad((seq(W) ** 2).sum(), W)
    return out


def _comms_kept(mesh):
    """Switching meshes inside one process group reuses each mesh's
    MeshComm (its axis groups are made once), leaves ``current()`` the
    spawned mesh's, and inside a ``shard_map`` body ``current()`` is the
    body's mesh."""
    from repro_torch.distributed.mesh import (P, Mesh, comm_for, current,
                                              shard_map)
    spawned = current()
    other = Mesh((2, 4), "gloo", "cpu", ("pod", "data"))
    first = comm_for(other)
    inside = shard_map(lambda a: a + float(current() is first), other,
                       in_specs=(P(),), out_specs=P())(torch.zeros(()))
    return [first is comm_for(other), comm_for(mesh) is spawned,
            current() is spawned, first is not spawned, float(inside) == 1.0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.distributed.mesh import Mesh, spawn
    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    Ws = rng.normal(0, 0.5, (S, D, D)).astype(np.float32)
    x = rng.normal(0, 1, (B, D)).astype(np.float32)
    np.savez(tmp / "data.npz", Ws=Ws, x=x)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_SCRIPT, str(tmp / "data.npz"),
         str(tmp / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = spawn(_port_rank, Mesh((4, 2), "gloo", "cpu", ("pod", "data")),
                     torch.from_numpy(Ws), torch.from_numpy(x), threads=1,
                     timeout=300)
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    return dict(np.load(tmp / "ref.npz")), port


def test_pipeline_forward_matches_reference(runs):
    ref, port = runs
    for r in port[1:]:
        assert torch.equal(r["y"], port[0]["y"])
    err = float(np.abs(port[0]["y"].numpy() - ref["y"]).max())
    assert err <= FWD_TOL, err
    assert torch.equal(port[0]["y"], port[0]["seq_y"])


def test_pipeline_gradients_match_reference(runs):
    ref, port = runs
    for r in port[1:]:
        assert torch.equal(r["g"], port[0]["g"])
    g = port[0]["g"].double().numpy()
    for want in (ref["g"].astype(np.float64),
                 port[0]["seq_g"].double().numpy()):
        assert np.linalg.norm(g - want) <= GRAD_REL * np.linalg.norm(want)


def test_bubble_fraction_and_reference_eager_refusal(runs):
    """``bubble_fraction(4, 4) == 3/7``; the reference's pipeline refuses
    its own test's eager calls on jax 0.9 (``jax.make_mesh``'s default
    Explicit axes)."""
    from repro_torch.distributed.pipeline import bubble_fraction
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert bubble_fraction(4, 1) == 3 / 4
    ref, _ = runs
    assert "set_mesh" in str(ref["eager_error"]), ref["eager_error"]


def test_mesh_comms_are_kept(runs):
    _, port = runs
    for r in port:
        assert r["comms"] == [True] * 5
