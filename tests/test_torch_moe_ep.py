"""PyTorch port: the expert-parallel MoE (``repro_torch.models.moe``:
``moe_ffn(axis_name=)``, the int8 dispatch, ``moe_ffn_shard_map``) held
against the JAX package's ``moe_ffn_shard_map``.

The reference runs once, in one subprocess with
``--xla_force_host_platform_device_count=8``: every case of ``CASES`` on
its mesh (``jax.make_mesh`` with ``AxisType.Auto`` axes, called under
``with mesh:`` and ``jax.jit``; on jax 0.9's default Explicit axes the
reference's mesh-aware paths fail), written to an ``.npz``.  Meanwhile
the port runs the same cases on gloo CPU ranks, one ``spawn`` per mesh
shape, every rank passing the same global arguments.  Both read the same
numpy inputs.

What must agree, and how closely:

* y: within ``Y_ULPS`` bf16 ulps of the largest magnitude, on the rows
  whose routing is sure under the margin rule (``test_torch_models.py``:
  the reference's router probabilities' k-th / (k+1)-th and top-1 / top-2
  gaps above 2**-7 of the largest); the port sums the shared experts'
  column-sharded partials in rank order, XLA in its own;
* ``aux`` within ``AUX_REL`` relative plus E / N for each row not sure
  (bf16 logits that round one ulp apart move the router probabilities
  by up to 2**-8 of a logit; measured 1.6e-4);
  ``dropped`` equal (the drops case has every row sure, so the same
  tokens overflow);
* the int8 dispatch: within ``Y_ULPS`` of the reference's int8 result
  (the quantized payload is bitwise the same: both round half to even),
  and within the reference test's 0.05 relative of the dense oracle;
* the gradient of a scalar loss of (y, aux) with respect to every
  parameter and x, with the compute dtype patched to f32 in both
  packages: each within ``GRAD_REL`` relative L2 of ``jax.grad``'s (the
  transpose rule of ``shard_map``, derived in ``distributed/mesh.py``);
* within the port: every rank returns the same bits, and the EP result
  equals the local ``moe_ffn`` run on each data shard alone within
  ``Y_ULPS`` (aux: the mean of the shards' to f32 rounding).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
Y_ULPS = 8
GRAD_REL = 1e-4
AUX_REL = 1e-3
D, B, L = 32, 4, 8
BASE = dict(n_experts=8, top_k=2, d_expert=16, n_shared=1,
            capacity_factor=8.0)
# name -> (mesh sizes over AXES[len], MoEConfig keywords, quantize_dispatch,
# grad); the batch is sharded over every axis but 'model'
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
CASES = {
    "base_24": ((2, 4), BASE, False, False),
    "int8_24": ((2, 4), BASE, True, False),
    "padded_24": ((2, 4), dict(BASE, n_experts=6), False, False),
    "replicated_shared_24": ((2, 4), dict(BASE, d_expert=18), False, False),
    "base_22": ((2, 2), BASE, False, False),
    "drops_22": ((2, 2), dict(BASE, capacity_factor=0.5, n_shared=2), False,
                 False),
    "grad_22": ((2, 2), BASE, False, True),
    "grad_24": ((2, 4), dict(BASE, n_experts=6), False, True),
    "pod_222": ((2, 2, 2), BASE, False, False),
    "grad_pod_222": ((2, 2, 2), BASE, False, True),
}
MESHES = sorted({c[0] for c in CASES.values()})
# the inputs' seeds; the drops case's routes every row surely (margin rule)
SEEDS = dict(zip(CASES, range(len(CASES))), drops_22=3)


def _params(name):
    """Seeded numpy params and x of one case (the reference's ``init_moe``
    shapes and scales, experts padded to the EP degree)."""
    mesh, kw, _, _ = CASES[name]
    m = mesh[-1]
    rng = np.random.default_rng(SEEDS[name])
    E = -(-kw["n_experts"] // m) * m
    F = kw["d_expert"]
    s = 1 / np.sqrt(D)
    p = {"router": rng.normal(0, s, (D, E)),
         "w_gate": rng.normal(0, s, (E, D, F)),
         "w_up": rng.normal(0, s, (E, D, F)),
         "w_down": rng.normal(0, 1 / np.sqrt(F), (E, F, D))}
    f = kw["n_shared"] * F
    p.update(ws_gate=rng.normal(0, s, (D, f)), ws_up=rng.normal(0, s, (D, f)),
             ws_down=rng.normal(0, 1 / np.sqrt(f), (f, D)))
    x = rng.normal(0, 1, (B, L, D))
    w = rng.normal(0, 1, (B, L, D))            # the loss's weights
    out = {k: v.astype(np.float32) for k, v in p.items()}
    return out, x.astype(np.float32), w.astype(np.float32)


_REFERENCE_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.models import moe as jmoe
    from repro.models.config import MoEConfig

    spec, data, out_path = sys.argv[1:4]
    cases = json.load(open(spec))
    arrs = dict(np.load(data))
    out = {}
    for name, (mesh_shape, kw, quant, grad) in cases.items():
        names = ("pod", "data", "model")[-len(mesh_shape):]
        dp = names[:-1]
        mesh = jax.make_mesh(tuple(mesh_shape), names,
                             axis_types=(AxisType.Auto,) * len(names),
                             devices=jax.devices()[:int(np.prod(mesh_shape))])
        cfg = MoEConfig(**kw)
        p = {k[len(name) + 3:]: jnp.asarray(v) for k, v in arrs.items()
             if k.startswith(name + "/p/")}
        x = jnp.asarray(arrs[name + "/x"])
        w = jnp.asarray(arrs[name + "/w"])
        Dm = x.shape[-1]
        xt = x.reshape(-1, Dm).astype(jnp.bfloat16)
        logits = (xt @ p["router"].astype(jnp.bfloat16)).astype(jnp.float32)
        if cfg.n_experts < logits.shape[1]:
            logits = jnp.where(jnp.arange(logits.shape[1])[None]
                               >= cfg.n_experts, -1e30, logits)
        out[name + "/probs"] = np.asarray(jax.nn.softmax(logits, -1))
        if grad:
            jmoe.COMPUTE_DTYPE = jnp.float32

            def loss(p, x):
                y, aux, _ = jmoe.moe_ffn_shard_map(p, x, cfg, mesh, dp)
                return jnp.sum(y.astype(jnp.float32) * w) + 0.5 * aux
            with mesh:
                val, (gp, gx) = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1)))(p, x)
            jmoe.COMPUTE_DTYPE = jnp.bfloat16
            out[name + "/loss"] = np.asarray(val)
            out[name + "/g/x"] = np.asarray(gx)
            for k, v in gp.items():
                out[name + "/g/" + k] = np.asarray(v)
            continue
        with mesh:
            y, aux, dropped = jax.jit(
                lambda p, x: jmoe.moe_ffn_shard_map(
                    p, x, cfg, mesh, dp, quantize_dispatch=quant))(p, x)
        out[name + "/y"] = np.asarray(y.astype(jnp.float32))
        out[name + "/aux"] = np.asarray(aux)
        out[name + "/dropped"] = np.asarray(dropped)
    np.savez(out_path, **out)
""")


def _port_mesh(sizes, data):
    """Every case of one mesh shape on this rank; rank 0 also runs the
    local ``moe_ffn`` on each data shard and the dense oracle."""
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.models import layers as tly
    from repro_torch.models import moe as tmoe
    from repro_torch.models.config import MoEConfig
    mesh = Mesh(sizes, "gloo", "cpu", AXES[len(sizes)])
    dp = AXES[len(sizes)][:-1]
    out = {}
    for name, (shape, kw, quant, grad) in CASES.items():
        if shape != sizes:
            continue
        cfg = MoEConfig(**kw)
        p = {k[len(name) + 3:]: torch.from_numpy(v)
             for k, v in data.items() if k.startswith(name + "/p/")}
        x = torch.from_numpy(data[name + "/x"])
        if grad:
            tly.COMPUTE_DTYPE = tmoe.COMPUTE_DTYPE = torch.float32
            p = {k: v.clone().requires_grad_() for k, v in p.items()}
            x = x.clone().requires_grad_()
            y, aux, _ = tmoe.moe_ffn_shard_map(p, x, cfg, mesh, dp)
            loss = (y.float() * torch.from_numpy(data[name + "/w"])).sum() \
                + 0.5 * aux
            gs = torch.autograd.grad(loss, [x] + list(p.values()))
            tly.COMPUTE_DTYPE = tmoe.COMPUTE_DTYPE = torch.bfloat16
            out[name + "/loss"] = loss.detach()
            out[name + "/g/x"] = gs[0]
            for k, g in zip(p, gs[1:]):
                out[name + "/g/" + k] = g
            continue
        y, aux, dropped = tmoe.moe_ffn_shard_map(
            p, x, cfg, mesh, dp, quantize_dispatch=quant)
        out[name + "/y"] = y.float()
        out[name + "/aux"], out[name + "/dropped"] = aux, dropped
        if name.startswith("base") and mesh_rank0():
            shards = [tmoe.moe_ffn(p, x[d * 2:(d + 1) * 2], cfg)
                      for d in range(2)]
            out[name + "/local_y"] = torch.cat([s[0] for s in shards]).float()
            out[name + "/local_aux"] = (shards[0][1] + shards[1][1]) / 2
            out[name + "/local_dropped"] = (shards[0][2] + shards[1][2]) / 2
        if quant and mesh_rank0():
            out[name + "/dense"] = tmoe.moe_ffn_dense_ref(p, x, cfg).float()
    return out


def mesh_rank0():
    from repro_torch.distributed.mesh import current
    return current().rank == 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference arrays, port per mesh: [per-rank outputs], inputs)``."""
    from repro_torch.distributed.mesh import Mesh, spawn
    tmp = tmp_path_factory.mktemp("moe_ep")
    data = {}
    for name in CASES:
        p, x, w = _params(name)
        data.update({f"{name}/p/{k}": v for k, v in p.items()})
        data[f"{name}/x"], data[f"{name}/w"] = x, w
    np.savez(tmp / "data.npz", **data)
    (tmp / "spec.json").write_text(json.dumps(CASES))
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_SCRIPT, str(tmp / "spec.json"),
         str(tmp / "data.npz"), str(tmp / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = {m: spawn(_port_mesh, Mesh(m, "gloo", "cpu", AXES[len(m)]),
                         m, data, threads=1, timeout=600) for m in MESHES}
        _, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    return dict(np.load(tmp / "ref.npz")), port, data


def _ulps(want, ulps=Y_ULPS):
    top = float(np.abs(want).max())
    return ulps * 2.0 ** (np.floor(np.log2(top)) - 7) if top else 0.0


def _sure_rows(probs, k):
    srt = -np.sort(-probs, axis=-1)
    tol = 2.0 ** -7 * float(probs.max())
    return (srt[:, k - 1] - srt[:, k] > tol) & (srt[:, 0] - srt[:, 1] > tol)


def _ranks_equal(ranks):
    r0 = ranks[0]
    for r in ranks[1:]:
        assert r.keys() == r0.keys()
        for k in r0:
            assert torch.equal(r[k], r0[k]), f"rank output {k} differs"


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if not c[3]])
def test_moe_ep_matches_reference(runs, name):
    """Every forward case on its mesh: y (sure rows), aux and dropped
    against the reference's; every rank bitwise equal."""
    ref, port, _ = runs
    shape, kw, quant, _ = CASES[name]
    ranks = port[shape]
    _ranks_equal([{k: v for k, v in r.items() if k.startswith(name + "/")
                   and "/local" not in k and "/dense" not in k}
                  for r in ranks])
    got = ranks[0]
    k = kw["top_k"]
    probs = ref[name + "/probs"]
    sure = _sure_rows(probs, k)
    want = ref[name + "/y"].reshape(-1, D)
    y = got[name + "/y"].numpy().reshape(-1, D)
    err = float(np.abs(y[sure] - want[sure]).max())
    assert err <= _ulps(want), f"{name}: y {err} > {_ulps(want)}"
    n_low = int((~sure).sum())
    e_over_n = probs.shape[1] / probs.shape[0]
    aux, waux = float(got[name + "/aux"]), float(ref[name + "/aux"])
    assert abs(aux - waux) <= AUX_REL * waux + e_over_n * n_low, name
    if name.startswith("drops"):
        assert n_low == 0, "the drops case must route every row surely"
        assert float(ref[name + "/dropped"]) > 0
    if n_low == 0:
        assert float(got[name + "/dropped"]) == float(ref[name + "/dropped"])
    if quant:
        dense = got[name + "/dense"].numpy()
        rel = np.abs(got[name + "/y"].numpy() - dense).max() \
            / np.abs(dense).max()
        assert rel < 0.05, rel


@pytest.mark.parametrize("name", ["base_24", "base_22"])
def test_ep_equals_local_moe_on_each_shard(runs, name):
    """The port's EP result equals its local ``moe_ffn`` on each data
    shard alone (same capacity, routing and drops): y within ``Y_ULPS``
    (the EP GEMMs run [E/m, m*C] rows, the shared experts' partials
    summed), aux the mean of the shards' to f32 rounding, dropped equal."""
    _, port, _ = runs
    got = port[CASES[name][0]][0]
    want = got[name + "/local_y"].numpy()
    err = float(np.abs(got[name + "/y"].numpy() - want).max())
    assert err <= _ulps(want), err
    aux, want_aux = float(got[name + "/aux"]), float(got[name + "/local_aux"])
    assert abs(aux - want_aux) <= 4 * np.spacing(np.float32(want_aux))
    assert float(got[name + "/dropped"]) == \
        float(got[name + "/local_dropped"])


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[3]])
def test_ep_gradient_matches_jax_grad(runs, name):
    """The gradient of sum(y * w) + aux / 2 with respect to every
    parameter and to x, f32 compute in both packages: each within
    ``GRAD_REL`` relative L2 of ``jax.grad``'s, the loss to f32 rounding;
    every rank holds the same global gradient, bitwise."""
    ref, port, _ = runs
    ranks = port[CASES[name][0]]
    _ranks_equal([{k: v for k, v in r.items() if k.startswith(name + "/")}
                  for r in ranks])
    got = ranks[0]
    loss, want_loss = float(got[name + "/loss"]), float(ref[name + "/loss"])
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    keys = [k for k in ref if k.startswith(name + "/g/")]
    assert len(keys) == 8
    for k in keys:
        g, w = got[k].double().numpy(), ref[k].astype(np.float64)
        assert g.shape == w.shape, k
        err = np.linalg.norm(g - w)
        assert err <= GRAD_REL * np.linalg.norm(w), \
            f"{k}: {err / np.linalg.norm(w)}"
