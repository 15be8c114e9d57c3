"""PyTorch port: LM training (``repro_torch.train.step``, ``forward(remat=)``,
the backward pass of the model modules, ``repro_torch.launch.train`` and
its checkpoints) held against the JAX package's.

Every test makes its inputs once with numpy from a seed and starts both
packages from the reference's own ``init_model`` / ``make_train_state``
tree, loaded into the port with ``params_from_reference`` (bitwise).
Reduced configs only (d_model 64, 2-4 layers, vocab 256).  The reference's
functions run through ``jax.jit``.

Tolerances.
* Gradients, with the compute dtype set to f32 in both packages: each
  leaf within ``F32_GRAD_REL`` relative L2 of ``jax.grad``'s (f32
  rounding through a few layers in another summation order, XLA's CPU
  FMA contraction; measured below 1e-5).  This is the backward's parity.
* One ``train_step`` at the models' bf16 compute
  (``tests/test_torch_train_step.py``): a bf16 rounding that
  falls the other way moves a value by 2**-8 relative, and through the
  layers and back a few such roundings add up, so the loss is held to
  ``LOSS_TOL`` (1/16 of a bf16 ulp at 4-8), the grad norm to
  ``GNORM_REL``, each moment leaf to ``BF16_REL`` relative L2 and
  ``BF16_COS`` cosine (measured: at most 4.4% and 0.9991 for mu, 5% for
  nu) -- except leaves whose norm is under 1/256 of the largest leaf's,
  such as zamba2's ``A_log`` (a sum with much cancellation: 14% of its
  2e-4), held to ``BF16_REL`` of that floor.  ``lr`` is bitwise (the
  warmup).  The first AdamW step moves each parameter by lr * (sign(g) +
  wd * p) where |g| >> eps, so the new params agree to ``lr * 1e-3`` plus
  two f32 ulps wherever both first moments share a sign and exceed 1e-5
  (|g| >= 1e-4), and everywhere within 2 lr (a bf16 sign flip of a tiny
  gradient; measured 0.1-0.8% of the elements).
* MoE expert choices follow the margin rule (``tests/test_torch_models.py``):
  where the reference's k-th / (k+1)-th and top-1 / top-2 router
  probabilities of a layer input differ by more than 2**-7 of the largest,
  the port's choice equals the reference's.
* ``remat``: ``False``, ``True`` and ``"dots"`` are bitwise equal (loss
  and every gradient), and the online path's per-KV-chunk checkpoint is
  bitwise its absence.
* The launchers: the losses of 12 steps within ``LAUNCH_TOL`` of the
  reference's step by step (bf16 drift compounded through 12 AdamW steps;
  measured 1.0e-4).  A resumed run of the port is bitwise its straight
  run, and checkpoints restore bitwise across the packages.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import checkpointer as jck
from repro.configs import registry as jreg
from repro.launch import train as jlaunch
from repro.models import layers as jly
from repro.models import mamba2 as jmamba
from repro.models import moe as jmoe
from repro.models import rwkv6 as jrwkv
from repro.models import transformer as jtf
from repro.optim import adamw as jadam
from repro.train import step as jstep
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.configs import registry as treg
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as tly
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_reference
from repro_torch.optim.adamw import adamw_init, tree_leaves
from repro_torch.train import step as tstep

torch.set_num_threads(1)

ARCHS = jreg.ARCHITECTURES
F32_GRAD_REL = 1e-4
LOSS_TOL = 2.0 ** -9
GNORM_REL = 2.0 ** -6
BF16_REL = 0.1
BF16_COS = 0.995
LAUNCH_TOL = 2.0 ** -8
STEP_KW = dict(peak_lr=1e-2, warmup=2, total_steps=10)
# the reference's init compiled whole (eagerly it dispatches op by op and
# costs seconds a model)
j_init = jax.jit(jtf.init_model, static_argnums=1)


def _ref_state(cfg, seed=0):
    params = j_init(jax.random.PRNGKey(seed), cfg)
    return jstep.TrainState(params=params, opt=jadam.adamw_init(params))


def _cfgs(arch):
    return (jreg.reduced_config(jreg.get_arch(arch)),
            treg.reduced_config(treg.get_arch(arch)))


def _batch(cfg, B=2, L=16, seed=1):
    """tokens, labels (the next tokens; a few masked with -1) and the vlm
    frontend, from a seed."""
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks, L + 1) if cfg.family == "audio" \
        else (B, L + 1)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels = toks[..., 1:].copy()
    labels[..., -2:] = -1
    fe = None
    if cfg.family == "vlm":
        fe = rng.normal(0, 1, (B, cfg.vision_tokens, cfg.d_vision))
        fe = fe.astype(np.float32)
    return toks[..., :-1], labels, fe


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _paths(tree):
    return jck._flatten_with_paths(tree)[0]


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _t_leaves(tree):
    return [x.detach().numpy() for x in tree_leaves(tree)]


def _ref_loss(cfg, tokens, labels, fe, forward=jtf.forward):
    def loss_fn(params):
        logits, aux, _ = forward(params, tokens, cfg, frontend_inputs=fe,
                                 remat=True)
        mask = (labels >= 0).astype(jnp.float32)
        loss = jtf.lm_loss(logits, jnp.maximum(labels, 0), mask)
        if cfg.moe is not None:
            loss = loss + cfg.moe.router_aux_weight * aux["moe_aux"]
        return loss
    return loss_fn


def _leaf_close(got, want, paths, rel, cos=None, what=""):
    """Per leaf: relative L2 error within ``rel`` (of the leaf's norm, or
    of 1/256 of the largest leaf norm where the leaf's is smaller) and,
    above that floor, the cosine at least ``cos``.  Returns the worst
    (relative error, cosine) above the floor."""
    floor = max(np.linalg.norm(w.astype(np.float64)) for w in want) / 256
    worst = (0.0, 1.0)
    for p, g, w in zip(paths, got, want):
        g, w = g.astype(np.float64), w.astype(np.float64)
        nw, err = np.linalg.norm(w), np.linalg.norm(g - w)
        assert err <= rel * max(nw, floor), \
            f"{what} {p}: |port - reference| {err} > {rel} x {max(nw, floor)}"
        if nw >= floor and cos is not None:
            c = float((g * w).sum() / (np.linalg.norm(g) * nw))
            assert c >= cos, f"{what} {p}: cosine {c} < {cos}"
            worst = (max(worst[0], err / nw), min(worst[1], c))
    return worst


# ----------------------------- gradients -------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch, monkeypatch):
    """The port's gradients (autograd through every model module: the
    stacked-layer unbind, MoE routing and capacity scatter, Mamba-2's
    softplus and chunked scan, RWKV-6's f32 state, the shared attention
    block) against ``jax.grad`` of the reference's masked loss, on the
    reference's params, with the compute dtype f32 in both packages: each
    leaf within ``F32_GRAD_REL`` relative L2, the loss to f32 rounding."""
    for mod in (jly, jmamba, jrwkv, jmoe):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (tly, tmamba, tmoe):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    jcfg, tcfg = _cfgs(arch)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tokens, labels, fe = _batch(jcfg)
    # the raw forward, traced afresh under the patched dtype (the jitted
    # one may hold a bf16 trace)
    loss_fn = _ref_loss(jcfg, tokens, labels, fe, jtf.forward.__wrapped__)
    wl, wg = jax.jit(jax.value_and_grad(loss_fn))(jp)
    gl, aux, gg = tstep.loss_and_grads(tp, _t(tokens), _t(labels), tcfg,
                                       frontend_inputs=_t(fe))
    assert abs(float(gl) - float(wl)) <= 4 * np.spacing(np.float32(wl))
    want, got = _np_leaves(wg), _t_leaves(gg)
    assert _paths(wg) == tck._flatten_with_paths(gg)[0]
    _leaf_close(got, want, _paths(wg), F32_GRAD_REL, 1 - F32_GRAD_REL,
                arch)


def test_unused_parameter_gets_zero_grad():
    """paligemma without its frontend never reads ``vision_proj``: its
    gradient is zeros, as ``jax.grad`` gives."""
    _, tcfg = _cfgs("paligemma-3b")
    tp = ttf.init_model(tcfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    tokens, labels, _ = _batch(tcfg)
    _, _, g = tstep.loss_and_grads(tp, _t(tokens), _t(labels), tcfg)
    assert not g["vision_proj"].any() and g["embed"]["table"].any()


# ----------------------------- remat -----------------------------------------

class CountDots(TorchDispatchMode):
    """Counts the matrix products (``aten.mm`` / ``bmm``) dispatched."""
    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_bitwise(arch):
    """``remat`` changes memory, never values: the loss and every gradient
    bitwise equal across False, True and "dots".  Counting the matrix
    products (``aten.mm`` / ``bmm``) of forward plus backward: True
    recomputes the checkpointed layers' products, "dots" saves them (as
    many as without remat), except that the moe stack checkpoints fully
    under "dots" too, as the reference's does."""
    _, tcfg = _cfgs(arch)
    tp = ttf.init_model(tcfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    tokens, labels, fe = _batch(tcfg, seed=4)
    out = {}
    for remat in (False, True, "dots"):
        with CountDots() as c:
            loss, _, g = tstep.loss_and_grads(tp, _t(tokens), _t(labels),
                                              tcfg, frontend_inputs=_t(fe),
                                              remat=remat)
        out[remat] = (loss, tree_leaves(g), c.n)
    for remat in (True, "dots"):
        assert torch.equal(out[remat][0], out[False][0]), remat
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1],
                                                     out[False][1])), remat
    n = {k: v[2] for k, v in out.items()}
    assert n[True] > n[False], n
    assert n["dots"] == (n[True] if tcfg.family == "moe" else n[False]), n


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma2-2b",
                                  "qwen2-moe-a2.7b", "zamba2-1.2b",
                                  "paligemma-3b"])
def test_remat_modes_bitwise_online(arch, monkeypatch):
    """The same on the online attention path (threshold, chunks patched
    to 8 / 8 / 16 at L = 64), where each KV step's checkpoint nests inside
    the layer's (full or selective): loss and gradients bitwise equal
    across False, True and "dots"."""
    monkeypatch.setattr(tly, "ATTN_CHUNK_THRESHOLD", 8)
    monkeypatch.setattr(tly, "ATTN_Q_CHUNK", 8)
    monkeypatch.setattr(tly, "ATTN_KV_CHUNK", 16)
    _, tcfg = _cfgs(arch)
    tp = ttf.init_model(tcfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    tokens, labels, fe = _batch(tcfg, L=64, seed=5)
    out, n = [], []
    for r in (False, True, "dots"):
        with CountDots() as c:
            out.append(tstep.loss_and_grads(tp, _t(tokens), _t(labels), tcfg,
                                            frontend_inputs=_t(fe), remat=r))
        n.append(c.n)
    for loss, _, g in out[1:]:
        assert torch.equal(loss, out[0][0])
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g),
                                                     tree_leaves(out[0][2])))
    # "dots" keeps the layer's products but not those inside a KV step
    # (the reference's policy sees nothing inside jax.checkpoint(kv_step)):
    # its recompute runs the KV steps' products again, not the others
    # (moe checkpoints fully under "dots"; the hybrid's attention block
    # lies outside its checkpointed Mamba layers)
    if tcfg.family in ("dense", "vlm", "audio"):
        assert n[0] < n[2] < n[1], n


def test_remat_off_without_autograd():
    """Under ``no_grad`` (serving) remat wraps nothing: no checkpoint is
    entered, the logits equal remat=False's."""
    _, tcfg = _cfgs("smollm-360m")
    tp = ttf.init_model(tcfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    tokens, _, _ = _batch(tcfg)
    with torch.no_grad():
        a = ttf.forward(tp, _t(tokens), tcfg, remat="dots")[0]
        b = ttf.forward(tp, _t(tokens), tcfg)[0]
    assert torch.equal(a, b) and not a.requires_grad


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attend_online_grad(dtype, monkeypatch):
    """The gradient of ``_attend_online`` (gemma2 reduced: softcap, a
    window of 8, a prefix of 20, max_kv 40; chunk constants 8 / 32, so the
    carry crosses 4 query and 2 key chunks) against the reference's
    ``jax.grad`` for q, k and v: f32 inputs within 1e-5 of the largest
    gradient, bf16 within 4 bf16 ulps of it; and the port's per-KV-chunk
    checkpoint bitwise the same loop without it."""
    jcfg, tcfg = _cfgs("gemma2-2b")
    for mod in (jly, tly):
        monkeypatch.setattr(mod, "ATTN_Q_CHUNK", 8)
        monkeypatch.setattr(mod, "ATTN_KV_CHUNK", 32)
    rng = np.random.default_rng(3)
    B, L, KV, hd = 2, 32, jcfg.n_kv_heads, 16
    G = jcfg.n_heads // KV
    arrs = [rng.normal(0, 1, s).astype(np.float32) for s in
            ((B, L, KV, G, hd), (B, 64, KV, hd), (B, 64, KV, hd))]
    w = rng.normal(0, 1, (B, L, KV, G, hd)).astype(np.float32)
    q_pos, kv_pos = np.arange(16, 48, dtype=np.int32), np.arange(
        64, dtype=np.int32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))

    def jloss(q, k, v):
        o = jly._attend_online(q, k, v, jnp.asarray(q_pos),
                               jnp.asarray(kv_pos), jcfg, 8, 20, 40)
        return jnp.sum(o.astype(jnp.float32) * w)
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *[jnp.asarray(a, jdt) for a in arrs])

    def tgrad():
        ins = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrs]
        o = tly._attend_online(*ins, _t(q_pos), _t(kv_pos), tcfg, 8, 20, 40)
        return torch.autograd.grad((o.float() * _t(w)).sum(), ins)
    got = tgrad()
    for name, g, wnt in zip("qkv", got, want):
        wnt = np.asarray(wnt.astype(jnp.float32))
        top = float(np.abs(wnt).max())
        tol = 1e-5 * top if dtype == "f32" else \
            4 * 2.0 ** (np.floor(np.log2(top)) - 7)
        err = float(np.abs(g.float().numpy() - wnt).max())
        assert err <= tol, f"d{name}: {err} > {tol}"
    monkeypatch.setattr(tly, "checkpoint",
                        lambda fn, *a, use_reentrant, **kw: fn(*a, **kw))
    for a, b in zip(tgrad(), got):
        assert torch.equal(a, b)


# ----------------------------- API edges -------------------------------------

def test_unported_and_no_card(monkeypatch):
    """``mesh=`` outside a rank of the mesh raises (no one-process
    fallback); GSPMD shardings raise naming the JAX-only dry-run; without
    a card the default device raises (no CPU fallback)."""
    _, tcfg = _cfgs("smollm-360m")
    st = tstep.make_train_state(tcfg, generator=torch.Generator(),
                                device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="not on a rank of this mesh"):
        tstep.train_step(st, tok, tok, tcfg, mesh=object())
    with pytest.raises(NotImplementedError, match="GSPMD placements"):
        tstep.make_train_step(tcfg, in_shardings=object())
    with pytest.raises(RuntimeError, match="not on a rank of this mesh"):
        ttf.forward(st.params, tok, tcfg, mesh=object(), remat=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstep.make_train_state(tcfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "smollm-360m", "--steps", "1"])


# ----------------------------- launchers -------------------------------------

def _ref_state_for(monkeypatch):
    """The port's launcher started from the reference's init of the same
    seed (``repro.train.step.make_train_state(PRNGKey(seed))``)."""
    def make(cfg, *, generator, device=None, ep_degree=1):
        js = _ref_state(jreg.reduced_config(jreg.get_arch(cfg.name)),
                        generator.initial_seed())
        tp = params_from_reference(jax.tree.map(np.asarray, js.params), cfg,
                                   device)
        return tstep.TrainState(tp, adamw_init(tp))
    monkeypatch.setattr(tlaunch, "make_train_state", make)


def _messages(caplog, word):
    return [r.getMessage() for r in caplog.records if word in r.getMessage()]


def test_launcher_matches_reference(monkeypatch, caplog):
    """``main(["--arch", "smollm-360m", "--steps", "12", "--device",
    "cpu"])`` from the reference's init against ``repro.launch.train``:
    the 12 losses within ``LAUNCH_TOL`` step by step, both runs logging
    IMPROVED; the port's own init (the default) also improves."""
    argv = ["--arch", "smollm-360m", "--steps", "12"]
    with caplog.at_level(logging.INFO):
        want = jlaunch.main(argv)
        own = tlaunch.main(argv + ["--device", "cpu"])
        _ref_state_for(monkeypatch)
        got = tlaunch.main(argv + ["--device", "cpu"])
    assert len(got) == len(want) == len(own) == 12
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.max() <= LAUNCH_TOL, diff
    assert abs(got[0] - want[0]) <= LOSS_TOL
    improved = _messages(caplog, "IMPROVED")
    assert len(improved) == 3, _messages(caplog, "->")
    assert np.mean(got[-10:]) < np.mean(got[:10])


def test_resume_is_bitwise_the_straight_run(tmp_path, caplog):
    """The port's restart claim: 8 straight steps against 4 steps, then
    ``--resume`` to 8 from the step-4 checkpoint: the resumed losses and
    the final checkpoint's leaves bitwise the straight run's (the
    pipeline is indexed by step; the warmup's lr does not read
    ``--steps``)."""
    base = ["--arch", "qwen2-moe-a2.7b", "--device", "cpu", "--ckpt-every",
            "4"]
    a, b = tmp_path / "straight", tmp_path / "resumed"
    with caplog.at_level(logging.INFO):
        straight = tlaunch.main(base + ["--steps", "8", "--ckpt-dir", str(a)])
        head = tlaunch.main(base + ["--steps", "4", "--ckpt-dir", str(b)])
        tail = tlaunch.main(base + ["--steps", "8", "--ckpt-dir", str(b),
                                    "--resume"])
    assert "resumed from step 4" in _messages(caplog, "resumed")
    assert head + tail == straight
    fa, sa = tck.load_checkpoint_flat(a)
    fb, sb = tck.load_checkpoint_flat(b)
    assert sa == sb == 8 and fa.keys() == fb.keys()
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_checkpoints_cross_packages(tmp_path, caplog):
    """The port's ``TrainState`` flattens to the reference's paths
    (``.params/...``, ``.opt/.step``, ``.opt/.mu/...``, ``.opt/.nu/...``);
    a checkpoint of ``repro.launch.train`` restores into the port bitwise
    and ``repro_torch.launch.train --resume`` goes on from it; the port's
    checkpoint restores into the reference bitwise and
    ``repro.launch.train --resume`` goes on from it."""
    jcfg, tcfg = _cfgs("smollm-360m")
    js = _ref_state(jcfg)
    ts = tstep.make_train_state(tcfg, generator=torch.Generator(),
                                device="cpu")
    paths = _paths(js)
    assert tck._flatten_with_paths(ts)[0] == paths
    assert paths[0] == ".params/embed/table" and ".opt/.step" in paths
    assert ".opt/.mu/embed/table" in paths and ".opt/.nu/final_norm/scale" \
        in paths
    d = str(tmp_path / "ck")
    argv = ["--arch", "smollm-360m", "--ckpt-dir", d, "--ckpt-every", "2"]
    with caplog.at_level(logging.INFO):
        jlaunch.main(argv + ["--steps", "4"])
        ref4, _ = jck.load_checkpoint(d, js)
        got4, step = tck.load_checkpoint(d, ts)
        assert step == 4 and isinstance(got4.params, ttf.ParamTree)
        assert got4.params["embed"]["table"].requires_grad
        for a, b in zip(_t_leaves(got4), _np_leaves(ref4)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        tlaunch.main(argv + ["--steps", "6", "--resume", "--device", "cpu"])
        got6, step = tck.load_checkpoint(d, ts)
        ref6, _ = jck.load_checkpoint(d, js)
        assert step == 6
        for a, b in zip(_t_leaves(got6), _np_leaves(ref6)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        jlaunch.main(argv + ["--steps", "8", "--resume"])
    resumed = _messages(caplog, "resumed from step")
    assert resumed == ["resumed from step 4", "resumed from step 6"]
