"""PyTorch port: the distributed LM (``forward`` / ``prefill_step`` /
``decode_step`` / ``train_step`` with ``mesh=``) held against the JAX
package's, on the reduced MoE configurations (qwen2-moe-a2.7b and
moonshot-v1-16b-a3b: d_model 64, 8 experts top-2, moonshot's first layer
dense) on the mesh (data, model) = (2, 2).

The reference runs once, in one subprocess with
``--xla_force_host_platform_device_count=4``: ``jax.make_mesh`` with
``AxisType.Auto`` axes, every call under ``with mesh:`` and ``jax.jit``.
On jax 0.9's default Explicit axes its mesh-aware ``forward`` fails (a
scan carry sharded over 'data'; ``train_step``: "Contracting dimensions
are sharded"), which the subprocess records (ROADMAP Queue 3).  The port
runs the same on four gloo CPU ranks (one ``spawn``), every rank passing
the same global arguments.  Both start from the same weights: the port's
seeded init, read into the reference's tree with ``params_to_numpy``.

What must agree, and how closely (the bounds of
``tests/test_torch_models.py`` and ``tests/test_torch_train.py``, whose
docstrings give their reasons):

* the MoE layers' expert choices under the margin rule; a token whose
  routing is not sure in some layer may take another expert (its logits
  then move by more than rounding), so the comparisons below skip such
  tokens (8-9 of the 64 here);
* ``forward(mesh=)``: logits within ``BF16_ULPS`` bf16 ulps of the
  largest; ``moe_aux`` (per data shard, then ``pmean``'d: not the global
  batch's aux) within 1e-3 relative plus E / N a token not sure, over the
  layers' mean; ``moe_dropped`` equal (zero);
* ``prefill_step`` / ``decode_step`` with ``mesh=``: the logits and every
  cache leaf within ``BF16_ULPS``;
* one ``train_step(mesh=, dp_axes=("data",))``: loss within ``LOSS_TOL``,
  grad norm within ``GNORM_REL``, the moments within ``BF16_REL`` /
  ``BF16_COS``, the new params by the first AdamW step's sign rule, lr
  bitwise;
* within the port: every rank's outputs, new params and moments bitwise
  equal; a dense family's ``forward(mesh=)`` bitwise its forward without
  a mesh; the mesh step's gradients bitwise equal under ``remat`` False,
  True and "dots".
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
MOE_ARCHS = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")
B, L, LP = 4, 16, 12            # batch, train length, prefill length
# test_torch_train.py's STEP_KW (held equal below)
STEP_KW = dict(peak_lr=1e-2, warmup=2, total_steps=10)
DP = ("data",)

_REFERENCE_SCRIPT = textwrap.dedent("""
    import os, sys, json, functools
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import registry as reg
    from repro.models import transformer as tf
    from repro.optim.adamw import adamw_init
    from repro.serve import engine
    from repro.train import step as st

    data, out_path = sys.argv[1:3]
    arrs = dict(np.load(data))
    step_kw = json.loads(str(arrs.pop("step_kw")))
    out = {}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)

    def tree(prefix):
        t = {}
        for k, v in arrs.items():
            if k.startswith(prefix):
                node = t
                parts = k[len(prefix):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = jnp.asarray(v)
        return t

    def flat(prefix, t):
        for k, v in t.items():
            if isinstance(v, dict):
                flat(prefix + k + "/", v)
            else:
                out[prefix + k] = np.asarray(v.astype(jnp.float32))

    for arch in json.loads(str(arrs.pop("archs"))):
        cfg = reg.reduced_config(reg.get_arch(arch))
        params = tree(arch + "/p/")
        tok = jnp.asarray(arrs[arch + "/tokens"])
        lab = jnp.asarray(arrs[arch + "/labels"])
        fwd = jax.jit(functools.partial(tf.forward, cfg=cfg, mesh=mesh,
                                        dp_axes=("data",)))
        with mesh:
            logits, aux, _ = fwd(params, tok)
            out[arch + "/logits"] = np.asarray(logits)
            out[arch + "/moe_aux"] = np.asarray(aux["moe_aux"])
            out[arch + "/moe_dropped"] = np.asarray(aux["moe_dropped"])
            cache = tf.init_cache(cfg, tok.shape[0], tok.shape[1])
            pl, cache = engine.prefill_step(params, tok[:, :-4], cache, cfg,
                                            mesh=mesh, dp_axes=("data",))
            out[arch + "/prefill"] = np.asarray(pl)
            flat(arch + "/prefill_cache/", cache)
            n = tok.shape[1] - 4
            dl, cache = engine.decode_step(params, tok[:, n:n + 1], cache,
                                           jnp.int32(n), cfg, mesh=mesh,
                                           dp_axes=("data",))
            out[arch + "/decode"] = np.asarray(dl)
            flat(arch + "/decode_cache/", cache)
            state = st.TrainState(params=params, opt=adamw_init(params))
            f = jax.jit(functools.partial(st.train_step, cfg=cfg, mesh=mesh,
                                          dp_axes=("data",), **step_kw))
            state, metrics = f(state, tok, lab)
        for k, v in metrics.items():
            out[arch + "/m/" + k] = np.asarray(v)
        flat(arch + "/new/", state.params)
        flat(arch + "/mu/", state.opt.mu)
        flat(arch + "/nu/", state.opt.nu)
        # jax.make_mesh's default (Explicit) axes under jax.set_mesh
        try:
            emesh = jax.make_mesh((2, 2), ("data", "model"))
            with jax.set_mesh(emesh):
                jax.jit(functools.partial(tf.forward, cfg=cfg, mesh=emesh,
                                          dp_axes=("data",)))(params, tok)
            out[arch + "/explicit_error"] = np.asarray("")
        except Exception as e:
            out[arch + "/explicit_error"] = np.asarray(str(e)[:300])
    np.savez(out_path, **out)
""")


def _tree_np(t, prefix=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(_tree_np(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _flat(t, prefix=""):
    t = t.tree() if hasattr(t, "tree") else t
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().clone()
    return out


def _port_rank(arrays):
    """Every MoE architecture's forward, prefill / decode and train step
    with ``mesh=`` on this rank (rank 0 also records the MoE layers'
    inputs), then the dense-family and remat checks."""
    from repro_torch.configs import registry as treg
    from repro_torch.distributed.mesh import Mesh, current
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer as ttf
    from repro_torch.models.convert import params_from_reference
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.serve import engine
    from repro_torch.train import step as tstep
    mesh = Mesh((2, 2), "gloo", "cpu", ("data", "model"))
    out = {}

    def tree(prefix):
        t = {}
        for k, v in arrays.items():
            if k.startswith(prefix):
                node = t
                parts = k[len(prefix):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = v
        return t

    seen = []
    real = tmoe.moe_ffn_shard_map

    def rec(p, h, *a, **kw):
        seen.append(h.detach().clone())
        return real(p, h, *a, **kw)
    tmoe.moe_ffn_shard_map = rec
    for arch in MOE_ARCHS:
        cfg = treg.reduced_config(treg.get_arch(arch))
        tree_np = tree(arch + "/p/")
        tp = params_from_reference(tree_np, cfg, "cpu")
        tok = torch.from_numpy(arrays[arch + "/tokens"])
        lab = torch.from_numpy(arrays[arch + "/labels"])
        seen.clear()
        with torch.no_grad():
            logits, aux, _ = ttf.forward(tp, tok, cfg, mesh=mesh, dp_axes=DP)
        out[arch + "/logits"] = logits
        out[arch + "/moe_aux"] = aux["moe_aux"]
        out[arch + "/moe_dropped"] = aux["moe_dropped"]
        out.update({f"{arch}/fwd_in/{i}": h for i, h in enumerate(seen)})
        cache = ttf.init_cache(cfg, B, L, device="cpu")
        pl, cache = engine.prefill_step(tp, tok[:, :LP], cache, cfg,
                                        mesh=mesh, dp_axes=DP)
        out[arch + "/prefill"] = pl
        out.update(_flat(cache, arch + "/prefill_cache/"))
        dl, cache = engine.decode_step(tp, tok[:, LP:LP + 1], cache, LP,
                                       cfg, mesh=mesh, dp_axes=DP)
        out[arch + "/decode"] = dl
        out.update(_flat(cache, arch + "/decode_cache/"))
        seen.clear()
        state = tstep.TrainState(tp, adamw_init(tp))
        state, metrics = tstep.train_step(state, tok, lab, cfg, mesh=mesh,
                                          dp_axes=DP, **STEP_KW)
        out.update({f"{arch}/m/{k}": v for k, v in metrics.items()})
        out.update({f"{arch}/train_in/{i}": h for i, h in enumerate(seen)})
        out.update(_flat(state.params, arch + "/new/"))
        out.update(_flat(state.opt.mu, arch + "/mu/"))
        out.update(_flat(state.opt.nu, arch + "/nu/"))
        if arch == MOE_ARCHS[1]:
            # the mesh step's gradients under every remat mode
            tp = params_from_reference(tree_np, cfg, "cpu")
            grads = [tstep.loss_and_grads(tp, tok, lab, cfg, remat=r,
                                          mesh=mesh, dp_axes=DP)[2]
                     for r in (False, True, "dots")]
            out["remat_equal"] = torch.tensor(all(
                torch.equal(a, b) for g in grads[1:]
                for a, b in zip(_flat(grads[0]).values(),
                                _flat(g).values())))
    tmoe.moe_ffn_shard_map = real
    # a family without MoE blocks: mesh= changes nothing
    cfg = treg.reduced_config(treg.get_arch("smollm-360m"))
    tp = ttf.init_model(cfg, generator=torch.Generator().manual_seed(1),
                        device="cpu")
    tok = torch.from_numpy(arrays[MOE_ARCHS[0] + "/tokens"])
    with torch.no_grad():
        out["dense_equal"] = torch.tensor(torch.equal(
            ttf.forward(tp, tok, cfg, mesh=mesh, dp_axes=DP)[0],
            ttf.forward(tp, tok, cfg)[0]))
    if current().rank:
        out = {k: v for k, v in out.items() if "_in/" not in k}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference arrays, port per rank, the inputs)``."""
    from repro_torch.configs import registry as treg
    from repro_torch.distributed.mesh import Mesh, spawn
    from repro_torch.models import transformer as ttf
    from repro_torch.models.convert import params_to_numpy
    tmp = tmp_path_factory.mktemp("lm_mesh")
    arrays = {}
    for i, arch in enumerate(MOE_ARCHS):
        cfg = treg.reduced_config(treg.get_arch(arch))
        tp = ttf.init_model(cfg, generator=torch.Generator().manual_seed(i),
                            device="cpu", ep_degree=2)
        arrays.update({f"{arch}/p/{k}": v for k, v in
                       _tree_np(params_to_numpy(tp)).items()})
        rng = np.random.default_rng(i)
        toks = rng.integers(0, cfg.vocab_size, (B, L + 1)).astype(np.int32)
        labels = toks[:, 1:].copy()
        labels[:, -2:] = -1
        arrays[f"{arch}/tokens"], arrays[f"{arch}/labels"] = \
            toks[:, :-1].copy(), labels
    import json
    np.savez(tmp / "data.npz", **arrays, archs=np.asarray(
        json.dumps(MOE_ARCHS)), step_kw=np.asarray(json.dumps(STEP_KW)))
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_SCRIPT, str(tmp / "data.npz"),
         str(tmp / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = spawn(_port_rank, Mesh((2, 2), "gloo", "cpu",
                                      ("data", "model")), arrays,
                     threads=1, timeout=600)
        _, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    return dict(np.load(tmp / "ref.npz")), port, arrays


def _bf16_tol(want):
    from test_torch_models import _bf16_tol as tol
    return tol(want)


def _close(got, want, atol, what):
    g = got.detach().float().numpy()
    assert g.shape == want.shape, (what, g.shape, want.shape)
    err = float(np.abs(g - want).max())
    assert err <= atol, f"{what}: max |port - reference| {err} > {atol}"


def _ref_tree(arrays, prefix):
    t = {}
    for k, v in arrays.items():
        if k.startswith(prefix):
            node = t
            parts = k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return t


def _routing(arrays, arch, got, key, n_moe):
    """The margin rule on the port's recorded MoE layer inputs: the
    reference's routing of each (its bf16 logits' f32 softmax); where the
    k-th / (k+1)-th and top-1 / top-2 probabilities differ by more than
    2**-7 of the largest, the port's expert choices must equal it.
    Returns (the [B, L] mask of tokens sure in every layer, the bound on
    |aux - reference aux| that the others allow: E / N a token, over the
    layers' mean)."""
    import jax
    import jax.numpy as jnp
    from repro_torch.configs import registry as treg
    from repro_torch.models import moe as tmoe
    cfg = treg.reduced_config(treg.get_arch(arch))
    router = _ref_tree(arrays, arch + "/p/")["layers"]["moe"]["router"]
    sure_all = np.ones(B * L, bool)
    low = 0
    for i in range(n_moe):
        h = got[f"{arch}/{key}/{i}"]
        D = h.shape[-1]
        hj = jnp.asarray(h.float().numpy(), jnp.bfloat16).reshape(-1, D)
        probs = np.asarray(jax.nn.softmax((hj @ jnp.asarray(
            router[i], jnp.bfloat16)).astype(jnp.float32), axis=-1))
        logits = (h.reshape(-1, D).bfloat16()
                  @ torch.from_numpy(router[i]).bfloat16()).float()
        _, _, eidx = tmoe._route(logits, cfg.moe, logits.shape[1])
        k, tol = cfg.moe.top_k, 2.0 ** -7 * float(probs.max())
        order = np.argsort(-probs, axis=-1, kind="stable")
        srt = np.take_along_axis(probs, order, axis=-1)
        sure = (srt[:, k - 1] - srt[:, k] > tol) & (srt[:, 0] - srt[:, 1]
                                                    > tol)
        np.testing.assert_array_equal(
            np.sort(eidx.numpy(), -1)[sure], np.sort(order[:, :k], -1)[sure],
            err_msg=f"{arch} {key} layer {i}")
        low += int((~sure).sum())
        sure_all &= sure
    E = router.shape[-1]
    return sure_all.reshape(B, L), low * E / (B * L) / n_moe


def _ranks_equal(port, prefix):
    r0 = port[0]
    for r in port[1:]:
        for k, v in r.items():
            if k.startswith(prefix):
                assert torch.equal(v, r0[k]), f"rank output {k} differs"


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_serving_steps_match_reference(runs, arch):
    """``forward``, ``prefill_step`` and ``decode_step`` with ``mesh=``:
    logits, aux, dropped and every cache leaf; every rank bitwise."""
    ref, port, arrays = runs
    _ranks_equal(port, arch + "/")
    got = port[0]
    n_moe = 2 - (arch == MOE_ARCHS[1])
    sure, bound = _routing(arrays, arch, got, "fwd_in", n_moe)
    print(f"{arch}: {int((~sure).sum())} of {sure.size} tokens with a "
          "low routing margin")
    want = ref[arch + "/logits"]
    _close(got[arch + "/logits"][torch.from_numpy(sure)], want[sure],
           _bf16_tol(want), "logits")
    waux = float(ref[arch + "/moe_aux"])
    assert abs(float(got[arch + "/moe_aux"]) - waux) <= 1e-3 * waux + bound
    assert float(got[arch + "/moe_dropped"]) == 0.0
    assert abs(float(ref[arch + "/moe_dropped"])) < 1e-6
    # the prefill's and the decode step's tokens route as the forward's
    # (causal attention over the same tokens)
    for what, pos in (("prefill", LP - 1), ("decode", LP)):
        rows = sure[:, pos]
        want = ref[f"{arch}/{what}"]
        _close(got[f"{arch}/{what}"][torch.from_numpy(rows)], want[rows],
               _bf16_tol(want), what)
        keys = [k for k in ref if k.startswith(f"{arch}/{what}_cache/")]
        assert keys and all(k in got for k in keys)
        for k in keys:
            m = torch.from_numpy(sure)
            _close(got[k][:, m], ref[k][:, sure], _bf16_tol(ref[k]), k)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_on_mesh_matches_reference(runs, arch):
    """One ``train_step(mesh=, dp_axes=("data",))`` against the
    reference's jitted one from the same state and batch, within
    ``tests/test_torch_train.py``'s bounds; every rank ends with bitwise
    the same params and moments."""
    from test_torch_train import (BF16_COS, BF16_REL, GNORM_REL, LOSS_TOL,
                                  _leaf_close)
    from test_torch_train import STEP_KW as WANT_KW
    assert STEP_KW == WANT_KW
    ref, port, arrays = runs
    _ranks_equal(port, arch + "/")
    got = port[0]
    m = {k.split("/")[-1]: float(v) for k, v in got.items()
         if k.startswith(arch + "/m/")}
    wm = {k.split("/")[-1]: float(v) for k, v in ref.items()
          if k.startswith(arch + "/m/")}
    assert m.keys() == wm.keys()
    assert m["lr"] == wm["lr"]
    assert abs(m["loss"] - wm["loss"]) <= LOSS_TOL
    assert abs(m["grad_norm"] / wm["grad_norm"] - 1) <= GNORM_REL
    assert m["moe_dropped"] == 0.0
    n_moe = 2 - (arch == MOE_ARCHS[1])
    sure, bound = _routing(arrays, arch, got, "train_in", n_moe)
    low = int((~sure).sum())
    assert abs(m["moe_aux"] - wm["moe_aux"]) <= 1e-3 * wm["moe_aux"] + bound
    paths = sorted(k[len(arch) + 3:] for k in arrays
                   if k.startswith(arch + "/p/"))
    for what in ("mu", "nu"):
        keep = [p for p in paths if not (low and p.startswith("layers/moe"))]
        _leaf_close([got[f"{arch}/{what}/{p}"].numpy() for p in keep],
                    [ref[f"{arch}/{what}/{p}"] for p in keep], keep,
                    BF16_REL, BF16_COS, f"{arch} {what}")
    lr = wm["lr"]
    for p in paths:
        a = got[f"{arch}/new/{p}"].numpy()
        b = ref[f"{arch}/new/{p}"]
        ma, mb = got[f"{arch}/mu/{p}"].numpy(), ref[f"{arch}/mu/{p}"]
        d = np.abs(a - b)
        ulps = 2 * np.spacing(np.abs(b))
        sure = (np.sign(ma) == np.sign(mb)) & (np.abs(ma) > 1e-5) \
            & (np.abs(mb) > 1e-5)
        assert (d[sure] <= lr * 1e-3 + ulps[sure]).all(), f"{arch} {p}"
        assert (d <= 2 * lr + ulps).all(), f"{arch} {p}"


def test_mesh_invariants_and_reference_explicit_axes(runs):
    """A dense family's ``forward(mesh=)`` is bitwise its forward without
    a mesh; the mesh step's gradients are bitwise equal under every
    ``remat`` mode; the reference's mesh-aware forward fails on
    ``jax.make_mesh``'s default Explicit axes (ROADMAP Queue 3)."""
    ref, port, _ = runs
    assert all(bool(r["dense_equal"]) for r in port)
    assert all(bool(r["remat_equal"]) for r in port)
    for arch in MOE_ARCHS:
        err = str(ref[arch + "/explicit_error"])
        assert err, f"{arch}: the reference ran on Explicit axes"


def test_padded_experts_load_from_reference():
    """``params_from_reference(ep_degree=)`` takes the reference's tree
    with its experts padded to the EP degree (8 experts at 3 -> 9)."""
    import jax
    from repro.configs import registry as jreg
    from repro.models import transformer as jtf
    from repro_torch.configs import registry as treg
    from repro_torch.models.convert import params_from_reference
    jcfg = jreg.reduced_config(jreg.get_arch("qwen2-moe-a2.7b"))
    tree = jax.tree.map(np.asarray, jax.jit(
        jtf.init_model, static_argnums=1, static_argnames="ep_degree")(
        jax.random.PRNGKey(0), jcfg, ep_degree=3))
    tcfg = treg.reduced_config(treg.get_arch("qwen2-moe-a2.7b"))
    tp = params_from_reference(tree, tcfg, "cpu", ep_degree=3)
    assert tuple(tp["layers"]["moe"]["router"].shape) == (2, 64, 9)
    with pytest.raises(ValueError, match="not"):
        params_from_reference(tree, tcfg, "cpu")

