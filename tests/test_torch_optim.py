"""PyTorch port: the optimizer, its schedules, gradient compression and the
token pipeline (``repro_torch.optim``, ``repro_torch.data.pipeline``) held
against the JAX package's.

Inputs are made once with numpy from a seed and fed to both packages.

Tolerances.  The warmup schedule and every AdamW leaf are the
reference's bit for bit against its eager update (the same f32
operations in the same order); against ``jax.jit``'s, whose CPU fusion
contracts the chain into FMAs, within ``JIT_ULPS`` f32 ulps of each
leaf's largest magnitude.  The cosine part of
the schedule is within 4 f32 ulps: ``jnp.cos`` (XLA's polynomial) and
``torch.cos`` differ by an ulp or two, measured at most 2 over the steps
tested.  The global norm sums each leaf's squares in another order than
XLA's reduction, so it and the clipped grads are within 4 f32 ulps
relative.  Compression is bitwise (an absolute maximum, a division,
round half to even, a stable top-k).  Pipeline batches are bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget, reduced_config as jreduce
from repro.data.pipeline import TokenPipeline as JPipe
from repro.optim import adamw as jadam
from repro.optim import grad_compress as jgc
from repro.optim import schedule as jsched
from repro_torch.configs import get_arch as tget, reduced_config as treduce
from repro_torch.data.pipeline import TokenPipeline as TPipe
from repro_torch.optim import adamw as tadam
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim import schedule as tsched

torch.set_num_threads(1)
# ulps of a leaf's largest magnitude between the port's AdamW and the
# reference's under jax.jit: its CPU fusion contracts b1 * m + (1 - b1) * g
# into one FMA, which rounds once where the eager chain rounds twice
# (where the terms cancel, that is many ulps of the small result)
JIT_ULPS = 4
SHAPES = {"b": {"z": (3, 4), "a": (5,)}, "a": (7, 2), "c": {"q": (2, 2, 3)}}


def _tree(fn, shapes=SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in shapes.items()}


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _leaves_equal(got, want, what, ulps=0, of_leaf=False):
    """Equal leaves in the reference's order, each element within ``ulps``
    f32 ulps of the reference's element (``of_leaf``: of the leaf's
    largest magnitude); 0 is bitwise."""
    gl, wl = tadam.tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl), what
    for g, w in zip(gl, wl):
        g, w = _np(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, what
        mag = np.abs(w).max() if of_leaf else np.abs(w)
        assert (np.abs(g - w) <= ulps * np.spacing(mag)).all(), what


# ----------------------------- schedule --------------------------------------

@pytest.mark.parametrize("args", [(20, 12, 3e-3), (200, 10_000, 3e-4),
                                  (0, 0, 1.0), (7, 250, 1e-2)])
def test_schedules_match_reference(args):
    """``cosine_schedule`` and ``linear_warmup`` over steps 0-250, from a
    0-d int32 step tensor: f32 results, the warmup steps bitwise, the
    cosine steps within 4 f32 ulps (module docstring)."""
    warmup, total, peak = args
    for s in range(251):
        js, ts = jnp.int32(s), torch.tensor(s, dtype=torch.int32)
        w = np.asarray(jsched.linear_warmup(js, warmup, peak))
        g = tsched.linear_warmup(ts, warmup, peak)
        assert g.dtype == torch.float32 and g.item() == w.item(), s
        w = np.asarray(jsched.cosine_schedule(js, warmup, total, peak))
        g = tsched.cosine_schedule(ts, warmup, total, peak)
        assert g.dtype == torch.float32 and g.shape == ()
        if s < warmup:
            assert g.item() == w.item(), s
        else:
            assert abs(g.item() - w.item()) <= 4 * np.spacing(w), s


# ----------------------------- AdamW -----------------------------------------

@pytest.mark.parametrize("jit", [False, True])
def test_adamw_and_clip_match_reference(jit):
    """Five steps of clip -> AdamW on the same grads (nested dicts, keys
    out of order): the norm and clipped grads within 4 ulps, the params,
    moments and step bitwise the eager reference's (within ``JIT_ULPS``
    of each leaf's largest against its jitted update); the port's leaves in sorted-key order and its
    update in place."""
    rng = np.random.default_rng(0)
    p = _tree(lambda s: rng.normal(0, 1, s).astype(np.float32))
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p)
    js, ts = jadam.adamw_init(jp), tadam.adamw_init(tp)
    assert ts.step.dtype == torch.int32 and ts.step.item() == 0
    clip = jax.jit(jadam.clip_by_global_norm, static_argnums=1) if jit \
        else jadam.clip_by_global_norm
    upd = jax.jit(jadam.adamw_update) if jit else jadam.adamw_update
    first = tadam.tree_leaves(tp)[0]
    for it in range(5):
        g = _tree(lambda s: rng.normal(0, 3, s).astype(np.float32))
        jg, jn = clip(jax.tree.map(jnp.asarray, g), 1.0)
        tg, tn = tadam.clip_by_global_norm(jax.tree.map(torch.from_numpy, g),
                                           1.0)
        assert abs(tn.item() - float(jn)) <= 4 * np.spacing(np.float32(jn))
        _leaves_equal(tg, jg, f"clipped {it}", ulps=4)
        # the same clipped grads into both updates
        tg = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jg)
        lr = 1e-2 * (it + 1)
        jp, js = upd(jg, js, jp, lr=jnp.float32(lr))
        tp2, ts = tadam.adamw_update(tg, ts, tp, lr=torch.tensor(
            lr, dtype=torch.float32))
        assert tp2 is tp and tadam.tree_leaves(tp)[0] is first
        assert ts.step.item() == int(js.step) == it + 1
        for got, want, what in ((tp, jp, "params"), (ts.mu, js.mu, "mu"),
                                (ts.nu, js.nu, "nu")):
            _leaves_equal(got, want, f"{what} {it}", ulps=JIT_ULPS * jit,
                          of_leaf=True)


def test_adamw_converges_quadratic():
    """``tests/test_substrate.py``'s convergence test on the port."""
    target = torch.tensor([1.0, 2.0, -1.0])
    params = {"w": torch.tensor([5.0, -3.0, 2.0], requires_grad=True)}
    opt = tadam.adamw_init(params)

    def loss(p):
        return torch.sum((p["w"] - target) ** 2)

    for _ in range(300):
        g = {"w": torch.autograd.grad(loss(params), params["w"])[0]}
        g, _ = tadam.clip_by_global_norm(g, 10.0)
        params, opt = tadam.adamw_update(g, opt, params, lr=0.05,
                                         weight_decay=0.0)
    assert float(loss(params).detach()) < 1e-2


def test_grad_clip_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = tadam.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    total = torch.sqrt(sum(torch.sum(x ** 2)
                           for x in tadam.tree_leaves(clipped)))
    assert float(total) == pytest.approx(1.0, rel=1e-5)
    # under the limit: unchanged bits
    same, n = tadam.clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)
    assert torch.equal(same["a"], torch.full((4,), 0.1))
    assert float(n) == pytest.approx(0.2)


# ----------------------------- compression -----------------------------------

def test_int8_error_feedback_preserves_signal():
    """Sum of dequantized payloads + final residual == sum of true grads
    (``tests/test_substrate.py``'s test on the port)."""
    rng = np.random.default_rng(0)
    seq = [{"w": torch.from_numpy(rng.normal(0, 1, (32,)).astype(np.float32))}
           for _ in range(20)]
    ef = tgc.ef_init(seq[0])
    applied = torch.zeros(32)
    true = torch.zeros(32)
    for g in seq:
        payload, ef = tgc.compress_int8(g, ef)
        applied = applied + tgc.decompress_int8(payload)["w"]
        true = true + g["w"]
    np.testing.assert_allclose((applied + ef["w"]).numpy(), true.numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compressors_match_reference(kind):
    """Four steps with error feedback on the same grads: payloads (int8
    words and scales; kept values and their ids, ties among equal
    magnitudes included), residuals and the decompressed trees bitwise
    the reference's."""
    rng = np.random.default_rng(1)
    shapes = {"w": (6, 7), "b": {"x": (40,), "y": (3, 3)}}
    g0 = _tree(lambda s: np.zeros(s, np.float32), shapes)
    jef, tef = jgc.ef_init(jax.tree.map(jnp.asarray, g0)), tgc.ef_init(
        jax.tree.map(torch.from_numpy, g0))
    for it in range(4):
        # a few repeated magnitudes, so the top-k meets ties
        g = _tree(lambda s: np.round(rng.normal(0, 1, s), 1).astype(
            np.float32), shapes)
        jg = jax.tree.map(jnp.asarray, g)
        tg = jax.tree.map(torch.from_numpy, g)
        if kind == "int8":
            jpay, jef = jgc.compress_int8(jg, jef)
            tpay, tef = tgc.compress_int8(tg, tef)
            jd, td = jgc.decompress_int8(jpay), tgc.decompress_int8(tpay)
            for path in (("w",), ("b", "x"), ("b", "y")):
                jq, tq = jpay, tpay
                for k in path:
                    jq, tq = jq[k], tq[k]
                assert tq[0].dtype == torch.int8
                np.testing.assert_array_equal(tq[0].numpy(), np.asarray(jq[0]))
                assert tq[1].item() == float(jq[1])
        else:
            jpay, jef = jgc.compress_topk(jg, jef, ratio=0.1)
            tpay, tef = tgc.compress_topk(tg, tef, ratio=0.1)
            sh = _tree(lambda s: s, shapes)
            jd = jgc.decompress_topk(jpay, sh)
            td = tgc.decompress_topk(tpay, sh)
            for path in (("w",), ("b", "x"), ("b", "y")):
                jq, tq = jpay, tpay
                for k in path:
                    jq, tq = jq[k], tq[k]
                assert tq[1].dtype == torch.int32 and tq[2] == jq[2]
                np.testing.assert_array_equal(tq[1].numpy(), np.asarray(jq[1]))
                np.testing.assert_array_equal(tq[0].numpy(), np.asarray(jq[0]))
        _leaves_equal(tef, jef, f"{kind} residual {it}")
        _leaves_equal(td, jd, f"{kind} decompressed {it}")


def test_topk_ties_ascending():
    """Equal magnitudes go to the lower index, as ``lax.top_k``."""
    x = np.array([0.5, -2.0, 2.0, 1.0, -2.0, 0.0], np.float32)
    _, want = jax.lax.top_k(jnp.abs(jnp.asarray(x)), 3)
    _, got = tgc._top_k(torch.abs(torch.from_numpy(x)), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------- pipeline --------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-large",
                                  "paligemma-3b"])
def test_pipeline_matches_reference(arch):
    """``batch_at`` bitwise the reference's (dense, audio, vlm: keys,
    dtypes, shapes, values), a pure function of (seed, step): a fresh
    pipeline restarts the stream, another step differs; ``iterate``
    yields the same batches from any start."""
    jcfg, tcfg = jreduce(jget(arch)), treduce(tget(arch))
    jp, tp = JPipe(jcfg, 4, 32, seed=3), TPipe(tcfg, 4, 32, seed=3)
    for i in (0, 5, 6):
        want, got = jp.batch_at(i), tp.batch_at(i)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
    again = TPipe(tcfg, 4, 32, seed=3).batch_at(5)
    np.testing.assert_array_equal(again["tokens"], tp.batch_at(5)["tokens"])
    assert not np.array_equal(tp.batch_at(5)["tokens"],
                              tp.batch_at(6)["tokens"])
    it = tp.iterate(start_step=5)
    for i in (5, 6, 7):
        b = next(it)
        np.testing.assert_array_equal(b["tokens"], jp.batch_at(i)["tokens"])
    it.close()


def test_pipeline_is_learnable_structure():
    """``tests/test_substrate.py``'s branching test on the port."""
    cfg = treduce(tget("smollm-360m"))
    p = TPipe(cfg, batch=8, seq_len=64, seed=0)
    b = p.batch_at(0)
    pairs = {}
    for i in range(b["tokens"].shape[0]):
        for t in range(b["tokens"].shape[1]):
            pairs.setdefault(int(b["tokens"][i, t]), set()).add(
                int(b["labels"][i, t]))
    assert np.mean([len(v) for v in pairs.values()]) <= 12
