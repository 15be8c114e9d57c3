"""PyTorch port: one LM ``train_step`` per architecture held against the
JAX package's (bf16 compute, the reference's params and batch).

The helpers and the tolerances are ``tests/test_torch_train.py``'s (its
module docstring states each bound and its reason); this file holds the
per-architecture step apart so that xdist's loadfile runs it beside the
rest.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import step as jstep
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_reference
from repro_torch.optim.adamw import adamw_init
from repro_torch.train import step as tstep
from test_torch_train import (ARCHS, BF16_COS, BF16_REL, GNORM_REL, LOSS_TOL,
                              STEP_KW, _batch, _cfgs, _leaf_close,
                              _np_leaves, _paths, _ref_state, _t, _t_leaves)

torch.set_num_threads(1)


def _routing_check(jp, seen, jcfg, what):
    """The margin rule for every MoE layer input the port recorded: the
    port's expert choices against the reference's routing of the same
    input.  Returns the number of rows that are not sure."""
    low = 0
    for i, h in enumerate(seen):
        router = jp["layers"]["moe"]["router"][i]
        D = h.shape[-1]
        hj = jnp.asarray(h.detach().float().numpy(), jnp.bfloat16)
        probs = np.asarray(jax.nn.softmax((hj.reshape(-1, D) @ router.astype(
            jnp.bfloat16)).astype(jnp.float32), axis=-1))
        logits = (h.detach().reshape(-1, D)
                  @ torch.from_numpy(np.array(router)).bfloat16()).float()
        _, _, eidx = tmoe._route(logits, jcfg.moe, logits.shape[1])
        k, tol = jcfg.moe.top_k, 2.0 ** -7 * float(probs.max())
        order = np.argsort(-probs, axis=-1, kind="stable")
        srt = np.take_along_axis(probs, order, axis=-1)
        sure = (srt[:, k - 1] - srt[:, k] > tol) & (srt[:, 0] - srt[:, 1]
                                                    > tol)
        np.testing.assert_array_equal(
            np.sort(eidx.numpy(), -1)[sure], np.sort(order[:, :k], -1)[sure],
            err_msg=f"{what} layer {i}")
        low += int((~sure).sum())
    return low


@pytest.fixture
def record_moe(monkeypatch):
    seen = []
    real = tmoe.moe_ffn

    def rec(p, h, cfg, **kw):
        seen.append(h.detach().clone())
        return real(p, h, cfg, **kw)
    monkeypatch.setattr(tmoe, "moe_ffn", rec)
    return seen


# ----------------------------- one step --------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, record_moe):
    """One ``train_step`` (bf16 compute, remat=True) against the
    reference's jitted one from the same state and batch: the five
    metrics, the moments and the new params (module docstring's bounds);
    MoE choices under the margin rule."""
    jcfg, tcfg = _cfgs(arch)
    js = _ref_state(jcfg)
    p0 = jax.tree.map(np.asarray, js.params)
    tp = params_from_reference(p0, tcfg, "cpu")
    ts = tstep.TrainState(tp, adamw_init(tp))
    tokens, labels, fe = _batch(jcfg)
    f = jax.jit(functools.partial(jstep.train_step, cfg=jcfg, **STEP_KW))
    js, wm = f(js, tokens, labels, frontend_inputs=fe)
    ts2, gm = tstep.train_step(ts, _t(tokens), _t(labels), tcfg,
                               frontend_inputs=_t(fe), **STEP_KW)
    assert ts2.params is tp and sorted(gm) == sorted(wm)
    assert all(torch.is_tensor(v) and v.shape == () for v in gm.values())
    assert gm["lr"].item() == float(wm["lr"])
    assert int(ts2.opt.step) == int(js.opt.step) == 1
    assert abs(gm["loss"].item() - float(wm["loss"])) <= LOSS_TOL
    assert abs(gm["grad_norm"].item() / float(wm["grad_norm"]) - 1) \
        <= GNORM_REL
    assert float(gm["moe_dropped"]) == 0.0
    paths = _paths(js.params)
    low = 0
    if jcfg.family == "moe":
        # the forward's layer inputs (remat records them again in the
        # backward's recompute)
        n_moe = jcfg.n_layers - jcfg.moe.first_k_dense
        assert len(record_moe) == 2 * n_moe
        low = _routing_check(js.params, record_moe[:n_moe], jcfg, arch)
        # a top-1 flip moves one token's count between two experts: E / N
        # a row that is not sure, over the layers' mean
        E = js.params["layers"]["moe"]["router"].shape[-1]
        bound = 1e-3 * float(wm["moe_aux"]) + low * E / tokens.size / n_moe
        assert abs(gm["moe_aux"].item() - float(wm["moe_aux"])) <= bound
    else:
        assert not record_moe and float(gm["moe_aux"]) == 0.0
    for what, got, want in (("mu", ts2.opt.mu, js.opt.mu),
                            ("nu", ts2.opt.nu, js.opt.nu)):
        g, w = _t_leaves(got), _np_leaves(want)
        # where a routing choice is not sure, the expert leaves may differ
        keep = [i for i, p in enumerate(paths)
                if not (low and p.startswith("layers/moe"))]
        _leaf_close([g[i] for i in keep], [w[i] for i in keep],
                    [paths[i] for i in keep], BF16_REL, BF16_COS,
                    f"{arch} {what}")
    lr = float(wm["lr"])
    for p, before, a, b, ma, mb in zip(paths, _np_leaves(p0),
                                       _t_leaves(ts2.params),
                                       _np_leaves(js.params),
                                       _t_leaves(ts2.opt.mu),
                                       _np_leaves(js.opt.mu)):
        d = np.abs(a - b)
        ulps = 2 * np.spacing(np.abs(b))
        sure = (np.sign(ma) == np.sign(mb)) & (np.abs(ma) > 1e-5) \
            & (np.abs(mb) > 1e-5)
        assert (d[sure] <= lr * 1e-3 + ulps[sure]).all(), f"{arch} {p}"
        assert (d <= 2 * lr + ulps).all(), f"{arch} {p}"
        assert not np.array_equal(a, before) or not ma.any(), p
