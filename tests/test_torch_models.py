"""PyTorch port: the LM stack (``repro_torch.models``, the LM configs) held
against the JAX package's.

Every test builds its inputs once with numpy from a seed and runs both
packages on them; model tests start from the reference's own
``init_model`` tree, loaded into the port with ``params_from_reference``
(bitwise), so both run the same weights.  Reduced configs only
(``reduced_config``: d_model 64, 2-4 layers, vocab 256).

Tolerances.  Where the inputs and the computation are f32 the outputs
agree to f32 rounding (``F32_TOL``: XLA's CPU dots and cumsums sum in
another order than torch's).  The model computes in bf16 (f32 parameters
and reductions), as the reference does, and a bf16 rounding that falls
the other way moves a value by one bf16 ulp (2**-7 of the power of two
below it); through a few layers a few such ulps add up, so a bf16
comparison allows a stated number of ulps of the largest magnitude
compared (``_bf16_tol``; ``BF16_ULPS`` for whole models).
Discrete outputs (greedy tokens, MoE expert choices) must be equal
wherever the reference's top-1 / top-2 gap exceeds the tolerance of the
values ranked (the margin rule); a low-margin position is printed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as jly
from repro.models import linear_attn as jla
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tly
from repro_torch.models import linear_attn as tla
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_reference, params_to_numpy

torch.set_num_threads(1)

ARCHS = jreg.ARCHITECTURES
# the reference's functions compiled whole (its eager op-by-op dispatch
# compiles each op apart and costs the file more time); same values
j_init = jax.jit(jtf.init_model, static_argnums=1)
j_moe_ffn = jax.jit(jmoe.moe_ffn, static_argnums=2)
j_attention = jax.jit(jly.attention, static_argnames=(
    "cfg", "sliding_window", "prefix_len"))
j_chunked = jax.jit(jla.chunked_linear_attn, static_argnames=("mode",
                                                               "chunk"))
F32_TOL = 2e-5
BF16_ULPS = 8


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _bf16_tol(want, ulps=BF16_ULPS):
    """``ulps`` bf16 ulps at the largest magnitude of ``want``."""
    top = float(np.abs(_np(want)).max())
    return ulps * 2.0 ** (np.floor(np.log2(top)) - 7) if top else 0.0


def _close(got, want, atol, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = float(np.abs(g - w).max()) if g.size else 0.0
    assert err <= atol, f"{what}: max |port - reference| {err} > {atol}"
    return err


def _cfgs(arch):
    return (jreg.reduced_config(jreg.get_arch(arch)),
            treg.reduced_config(treg.get_arch(arch)))


def _params(arch, seed=0):
    jcfg, tcfg = _cfgs(arch)
    jp = j_init(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jp, tree, params_from_reference(tree, tcfg, "cpu")


def _inputs(cfg, B=2, L=12, seed=2):
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        tokens = rng.integers(0, cfg.vocab_size, (B, cfg.n_codebooks, L))
    else:
        tokens = rng.integers(0, cfg.vocab_size, (B, L))
    fe = None
    if cfg.family == "vlm":
        fe = rng.normal(0, 1, (B, cfg.vision_tokens, cfg.d_vision))
        fe = fe.astype(np.float32)
    return tokens.astype(np.int32), fe


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _margin_check(got_choice, want_scores, k, tol, what):
    """The margin rule: where the reference's k-th and (k+1)-th scores
    differ by more than ``tol``, the port's top-k choice equals the
    reference's.  Returns the number of rows compared."""
    s = _np(want_scores).reshape(-1, want_scores.shape[-1])
    got = np.asarray(got_choice).reshape(s.shape[0], -1)
    order = np.argsort(-s, axis=-1, kind="stable")
    srt = np.take_along_axis(s, order, axis=-1)
    gap = srt[:, k - 1] - srt[:, k]
    sure = gap > tol
    if (~sure).any():
        print(f"{what}: {int((~sure).sum())} low-margin rows, first "
              f"{int(np.argmax(~sure))} (gap {float(gap[~sure][0])})")
    want = np.sort(order[:, :k], axis=-1)
    np.testing.assert_array_equal(np.sort(got, axis=-1)[sure], want[sure],
                                  err_msg=what)
    return int(sure.sum())


# ----------------------------- configs ---------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_parity(arch):
    """Full and reduced configs equal the reference's field by field, as
    do the analytic counts and the shape table's verdicts."""
    full_j, full_t = jreg.get_arch(arch), treg.get_arch(arch)
    for j, t in ((full_j, full_t), _cfgs(arch)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert t.resolved_head_dim == j.resolved_head_dim
    assert treg.SHAPES == jreg.SHAPES
    for shape in jreg.SHAPES:
        assert (treg.shape_applicable(full_t, shape)
                == jreg.shape_applicable(full_j, shape))
    assert treg.ARCHITECTURES == jreg.ARCHITECTURES


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_round_trip(arch):
    """The reference's tree loads bitwise and reads back bitwise; the
    port's own init has the same paths and shapes, named with dots; all
    but the RMSNorm scales count to ``param_count`` where the analytic
    count is exact (not for rwkv and hybrid, whose count leaves out their
    mixing vectors, decays and biases)."""
    jcfg, tcfg, _, tree, tp = _params(arch)
    back = params_to_numpy(tp)
    jl, jdef = jax.tree.flatten(tree)
    bl, bdef = jax.tree.flatten(back)
    assert jdef == bdef
    for a, b in zip(jl, bl):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    own = ttf.init_model(tcfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    shapes = {n: tuple(p.shape) for n, p in tp.named_parameters()}
    assert {n: tuple(p.shape) for n, p in own.named_parameters()} == shapes
    assert all(p.dtype == torch.float32 for p in own.parameters())
    if tcfg.family in ("dense", "vlm", "audio"):
        assert shapes["layers.attn.wq"] == (tcfg.n_layers, 64, 4, 16)
    if tcfg.family not in ("rwkv", "hybrid"):
        n = sum(p.numel() for name, p in own.named_parameters()
                if not name.endswith(".scale") and name != "vision_proj")
        assert n == tcfg.param_count()
    with pytest.raises(ValueError, match="not"):
        bad = dict(tree)
        bad.pop("final_norm")
        params_from_reference(bad, tcfg, "cpu")


def test_init_distributions_follow_reference():
    """The port's init draws other bits from the same distributions: the
    standard deviations of smollm's leaves are the reference's (wo of
    shape [H, hd, d] scaled by 1/sqrt(H), the reference's fan-in)."""
    arch = "smollm-360m"
    jcfg, tcfg = _cfgs(arch)
    ref = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(3), jcfg))
    own = params_to_numpy(ttf.init_model(
        tcfg, generator=torch.Generator().manual_seed(3), device="cpu"))
    for path, want in (("embed.table", 0.02),
                       ("layers.attn.wq", 64 ** -0.5),
                       ("layers.attn.wo", 4 ** -0.5),
                       ("layers.mlp.wo", 128 ** -0.5)):
        a, b = ref, own
        for k in path.split("."):
            a, b = a[k], b[k]
        assert abs(a.std() - want) < 0.1 * want, path
        assert abs(b.std() - want) < 0.1 * want, path


# ----------------------------- layers ----------------------------------------

def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 9, 3, 16)).astype(np.float32)
    scale = rng.normal(0, 0.1, (16,)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        xj, xt = jnp.asarray(x, dt), torch.from_numpy(x).to(tdt)
        want = jly.rmsnorm({"scale": jnp.asarray(scale)}, xj)
        got = tly.rmsnorm({"scale": _t(scale)}, xt)
        assert got.dtype == tdt
        tol = F32_TOL if dt == jnp.float32 else _bf16_tol(want, 1)
        _close(got, want, tol, f"rmsnorm {dt}")
        want = jly.rope(xj, jnp.asarray(pos), 10_000.0)
        got = tly.rope(xt, torch.from_numpy(pos), 10_000.0)
        tol = 1e-4 if dt == jnp.float32 else _bf16_tol(want, 1)
        _close(got, want, tol, f"rope {dt}")


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(1)
    p = {k: rng.normal(0, 0.2, s).astype(np.float32) for k, s in
         (("wi_gate", (64, 128)), ("wi_up", (64, 128)), ("wo", (128, 64)))}
    x = rng.normal(0, 1, (2, 7, 64)).astype(np.float32)
    want = jly.mlp({k: _j(v) for k, v in p.items()}, jnp.asarray(x), act)
    got = tly.mlp({k: _t(v) for k, v in p.items()}, _t(x), act)
    _close(got, want, _bf16_tol(want, 2), act)


def _attn_case(arch, seed=0):
    jcfg, tcfg = _cfgs(arch)
    jp = jly.init_attention(jax.random.PRNGKey(seed), jcfg)
    tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("case", ["dense", "window_prefix_softcap"])
def test_attention_dense(case):
    """``attention`` on the dense path (L <= 2048), without a cache."""
    arch = "yi-6b" if case == "dense" else "gemma2-2b"
    jcfg, tcfg, jp, tp = _attn_case(arch)
    x = np.random.default_rng(2).normal(0, 1, (2, 24, 64)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32)
    kw = {} if case == "dense" else dict(sliding_window=8, prefix_len=5)
    want, _ = j_attention(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), **kw)
    got, _ = tly.attention(tp, _t(x), tcfg, _t(pos), **kw)
    _close(got, want, _bf16_tol(want, 2), case)


@pytest.mark.parametrize("case", ["chunks", "window_prefix_softcap"])
def test_attend_online_small(case, monkeypatch):
    """``_attend_online`` at small L through several chunks: both packages'
    chunk constants set to 8 / 16, so the running (m, l, acc) carries over
    4 query and 3 key chunks (the halving rule too: 48 -> 16)."""
    arch = "yi-6b" if case == "chunks" else "gemma2-2b"
    jcfg, tcfg = _cfgs(arch)
    for mod in (jly, tly):
        monkeypatch.setattr(mod, "ATTN_Q_CHUNK", 8)
        monkeypatch.setattr(mod, "ATTN_KV_CHUNK", 32)
    rng = np.random.default_rng(3)
    B, L, KV, hd = 2, 32, jcfg.n_kv_heads, 16
    G = jcfg.n_heads // KV
    q = rng.normal(0, 1, (B, L, KV, G, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, 48, KV, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, 48, KV, hd)).astype(np.float32)
    q_pos = np.arange(16, 48, dtype=np.int32)
    kv_pos = np.arange(48, dtype=np.int32)
    win, prefix = (1 << 30, None) if case == "chunks" else (8, 20)
    args_j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    args_t = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    want = jly._attend_online(*args_j, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                              jcfg, win, prefix, 40)
    got = tly._attend_online(*args_t, _t(q_pos), _t(kv_pos), tcfg, win,
                             prefix, 40)
    dense = tly._attend_dense(*args_t, _t(q_pos), _t(kv_pos), tcfg, win,
                              prefix, 40)
    _close(got, want, _bf16_tol(want, 2), "online vs reference")
    _close(got, dense, _bf16_tol(dense, 2), "online vs dense")


def test_attention_online_long():
    """``attention`` at L = 2304 > ATTN_CHUNK_THRESHOLD takes the online
    path in both packages (q chunks of 256 after the halving, k chunks of
    256): gemma2 reduced, so the window, the softcap and a prefix of 300
    are all live."""
    jcfg, tcfg, jp, tp = _attn_case("gemma2-2b", seed=1)
    L = 2304
    x = np.random.default_rng(4).normal(0, 1, (1, L, 64)).astype(np.float32)
    pos = np.arange(L, dtype=np.int32)
    want, _ = j_attention(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                            sliding_window=8, prefix_len=300)
    got, _ = tly.attention(tp, _t(x), tcfg, _t(pos), sliding_window=8,
                           prefix_len=300)
    _close(got, want, _bf16_tol(want, 2), "online L=2304")


def test_attention_cache_write():
    """With a cache: the new k / v land at ``cache_index`` in place, the
    queries attend up to ``cache_index + L - 1`` (``max_kv``), window and
    softcap live; output and cache equal the reference's."""
    jcfg, tcfg, jp, tp = _attn_case("gemma2-2b", seed=2)
    rng = np.random.default_rng(5)
    ck = rng.normal(0, 1, (2, 20, jcfg.n_kv_heads, 16)).astype(np.float32)
    cv = rng.normal(0, 1, ck.shape).astype(np.float32)
    x = rng.normal(0, 1, (2, 3, 64)).astype(np.float32)
    ci = 9
    pos = np.arange(ci, ci + 3, dtype=np.int32)
    jc = {"k": jnp.asarray(ck, jnp.bfloat16), "v": jnp.asarray(cv, jnp.bfloat16)}
    tc = {"k": _t(ck).bfloat16(), "v": _t(cv).bfloat16()}
    want, wc = j_attention(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                             cache=jc, cache_index=jnp.int32(ci),
                             sliding_window=8)
    got, gc = tly.attention(tp, _t(x), tcfg, _t(pos), cache=tc,
                            cache_index=ci, sliding_window=8)
    assert gc is tc
    _close(got, want, _bf16_tol(want, 2), "output")
    for f in ("k", "v"):
        _close(gc[f], wc[f], _bf16_tol(wc[f], 1), f"cache {f}")
        np.testing.assert_array_equal(_np(gc[f])[:, :ci], _np(jc[f])[:, :ci])
        np.testing.assert_array_equal(_np(gc[f])[:, ci + 3:],
                                      _np(jc[f])[:, ci + 3:])


def test_embed_unembed_softcap():
    rng = np.random.default_rng(6)
    table = rng.normal(0, 0.02, (256, 64)).astype(np.float32)
    tok = rng.integers(0, 256, (2, 5)).astype(np.int32)
    want = jly.embed({"table": jnp.asarray(table)}, jnp.asarray(tok), True)
    got = tly.embed({"table": _t(table)}, _t(tok), True)
    np.testing.assert_array_equal(_np(got), _np(want))
    x = rng.normal(0, 1, (2, 5, 64)).astype(np.float32)
    want = jly.unembed({"table": jnp.asarray(table)}, jnp.asarray(x),
                       final_softcap=0.05)
    got = tly.unembed({"table": _t(table)}, _t(x), final_softcap=0.05)
    assert got.dtype == torch.float32
    _close(got, want, _bf16_tol(want, 2), "unembed")


# ----------------------------- linear attention ------------------------------

def _la_data(seed, B=2, H=2, L=37, K=8, V=16, scalar=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, H, L, K)).astype(np.float32)
    k = rng.normal(0, 1, (B, H, L, K)).astype(np.float32)
    v = rng.normal(0, 1, (B, H, L, V)).astype(np.float32)
    shape = (B, H, L, 1) if scalar else (B, H, L, K)
    ld = -np.abs(rng.normal(0, 0.15, shape)).astype(np.float32)
    u = rng.normal(0, 1, (H, K)).astype(np.float32)
    return q, k, v, ld, u


@pytest.mark.parametrize("mode", ["mamba", "rwkv"])
@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_linear_attn(mode, chunk):
    """f32: ``chunked_linear_attn`` (padded L = 37) equals the reference's
    to f32 rounding, and the port's naive scan; bf16 operands (as the
    blocks pass them): within the bf16 tolerance."""
    q, k, v, ld, u = _la_data(0, scalar=mode == "mamba")
    wy, ws = j_chunked(*map(_j, (q, k, v, ld)), mode=mode,
                                     u=_j(u), chunk=chunk)
    gy, gs = tla.chunked_linear_attn(*map(_t, (q, k, v, ld)), mode=mode,
                                     u=_t(u), chunk=chunk)
    _close(gy, wy, 20 * F32_TOL, "y f32")
    _close(gs, ws, 20 * F32_TOL, "state f32")
    ny, ns = tla.naive_scan_ref(*map(_t, (q, k, v, ld)), mode=mode, u=_t(u))
    _close(gy, ny, 3e-3, "y vs naive scan")
    _close(gs, ns, 3e-3, "state vs naive scan")
    bj = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    bt = [_t(a).bfloat16() for a in (q, k, v)]
    wy, ws = j_chunked(*bj, _j(ld), mode=mode,
                                     u=jnp.asarray(u, jnp.bfloat16),
                                     chunk=chunk)
    gy, gs = tla.chunked_linear_attn(*bt, _t(ld), mode=mode,
                                     u=_t(u).bfloat16(), chunk=chunk)
    assert gy.dtype == torch.bfloat16 and gs.dtype == torch.float32
    _close(gy, wy, _bf16_tol(wy, 2), "y bf16")
    _close(gs, ws, _bf16_tol(ws, 2), "state bf16")


@pytest.mark.parametrize("mode", ["mamba", "rwkv"])
def test_linear_attn_step(mode):
    """One decode step after a carried state: the reference's step."""
    q, k, v, ld, u = _la_data(1, L=16)
    _, s0 = jla.naive_scan_ref(*map(_j, (q, k, v, ld)), mode=mode, u=_j(u))
    args = [a[:, :, 15] for a in (q, k, v, ld)]
    wy, ws = jla.linear_attn_step(*map(_j, args), s0, mode=mode, u=_j(u))
    gy, gs = tla.linear_attn_step(*map(_t, args), _t(np.asarray(s0)),
                                  mode=mode, u=_t(u))
    _close(gy, wy, 10 * F32_TOL, "y")
    _close(gs, ws, 10 * F32_TOL, "state")


# ----------------------------- MoE -------------------------------------------

def _moe_check(jp, tp, jmcfg, tmcfg, h, what):
    """One MoE layer on the same bf16 input ``h`` in both packages.  The
    expert choices follow the margin rule on the reference's router
    probabilities (an f32 softmax of bf16 logits: tolerance 2**-7 of the
    largest); on the rows whose top-1 and top-k choices are both sure the
    outputs agree within 4 bf16 ulps; ``aux`` agrees to 1e-4 relative
    plus E / N for each row that is not sure (a top-1 flip moves one
    token's count between two experts, whose mean probabilities are at
    most 1).  Returns (rows not sure, E / N)."""
    B, L, D = h.shape
    hj, ht = jnp.asarray(h, jnp.bfloat16), _t(h).bfloat16()
    wy, waux, wdrop = j_moe_ffn(jp, hj, jmcfg)
    gy, gaux, gdrop = tmoe.moe_ffn(tp, ht, tmcfg)
    assert float(gdrop) == 0.0 and abs(float(wdrop)) < 1e-6, what
    probs = _np(jax.nn.softmax((hj.reshape(-1, D) @ jp["router"].astype(
        jnp.bfloat16)).astype(jnp.float32), axis=-1))
    logits = (ht.reshape(-1, D) @ tp["router"].bfloat16()).float()
    _, _, eidx = tmoe._route(logits, tmcfg, logits.shape[1])
    k, tol = tmcfg.top_k, 2.0 ** -7 * float(probs.max())
    _margin_check(eidx.numpy(), probs, k, tol, what)
    srt = -np.sort(-probs, axis=-1)
    sure = (srt[:, k - 1] - srt[:, k] > tol) & (srt[:, 0] - srt[:, 1] > tol)
    want = _np(wy).reshape(-1, D)
    _close(_np(gy).reshape(-1, D)[sure], want[sure], _bf16_tol(want, 4),
           f"{what} output")
    e_over_n = probs.shape[1] / probs.shape[0]
    n_low = int((~sure).sum())
    _close(gaux, waux, 1e-4 * float(waux) + e_over_n * n_low, f"{what} aux")
    return n_low, e_over_n


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"])
def test_moe_ffn(arch):
    """``moe_ffn`` on the reduced MoE config (no drops at capacity factor
    8) against the reference's (``_moe_check``); on f32 input against the
    port's dense oracle with the reference's own ``atol=rtol=3e-2``
    (``tests/test_arch_smoke.py``) on the rows whose f32 routing is sure,
    and the oracle against the reference's oracle to f32 rounding."""
    jcfg, tcfg = _cfgs(arch)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), 64, jcfg.moe)
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(7).normal(0, 1, (2, 8, 64)).astype(np.float32)
    n_low, _ = _moe_check(jp, tp, jcfg.moe, tcfg.moe, x, arch)
    assert n_low <= 4
    ref = tmoe.moe_ffn_dense_ref(tp, _t(x), tcfg.moe)
    _close(ref, jmoe.moe_ffn_dense_ref(jp, jnp.asarray(x), jcfg.moe),
           10 * F32_TOL, "dense oracle")
    got, _, _ = tmoe.moe_ffn(tp, _t(x), tcfg.moe)
    probs = torch.softmax(_t(x).reshape(-1, 64) @ tp["router"], -1).numpy()
    srt = -np.sort(-probs, axis=-1)
    k, tol = tcfg.moe.top_k, 2.0 ** -7 * float(probs.max())
    sure = (srt[:, k - 1] - srt[:, k] > tol)
    np.testing.assert_allclose(_np(got).reshape(-1, 64)[sure],
                               _np(ref).reshape(-1, 64)[sure],
                               atol=3e-2, rtol=3e-2)


def test_top_k_ties_ascending():
    """Equal probabilities go to the lower expert, as ``lax.top_k``."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]],
                     np.float32)
    _, want = jax.lax.top_k(jnp.asarray(probs), 2)
    _, got = tmoe._top_k(_t(probs), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unported_branches_raise():
    """``mesh=`` and ``axis_name=`` outside a rank of the mesh raise (no
    one-process fallback); the ranks' paths are held in
    ``tests/test_torch_lm_mesh.py`` and ``tests/test_torch_moe_ep.py``."""
    jcfg, tcfg, _, _, tp = _params("qwen2-moe-a2.7b")
    tok = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="not on a rank of this mesh"):
        ttf.forward(tp, tok, tcfg, mesh=object())
    # remat is ported (the training slice): it runs and changes no value
    assert torch.equal(ttf.forward(tp, tok, tcfg, remat=True)[0],
                       ttf.forward(tp, tok, tcfg)[0])
    with pytest.raises(RuntimeError, match="not on a rank of this mesh"):
        tmoe.moe_ffn({}, torch.zeros((1, 1, 64)), tcfg.moe, axis_name="model")


def test_no_card_means_no_silent_cpu(monkeypatch):
    """Without a card the default device raises instead of using the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("smollm-360m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.init_model(tcfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.init_cache(tcfg, 1, 8)


# ----------------------------- whole models ----------------------------------

def _moe_layers_check(jp, tp, jcfg, tcfg, inputs):
    """Every MoE layer of the port's forward against the reference's
    ``moe_ffn`` on the same layer input (``_moe_check``); returns the
    bound on |port aux - reference aux| of the whole forward: 1e-3 of it
    (hidden states a few bf16 ulps apart) plus E / N for every row whose
    routing is not sure, over the layers' mean."""
    low, e_over_n = 0, 0.0
    fk = jcfg.moe.first_k_dense
    for i, h in enumerate(inputs):
        jl = jax.tree.map(lambda a: a[i], jp["layers"]["moe"])
        tl = {k: v[i] for k, v in tp["layers"]["moe"].tree().items()}
        n, e_over_n = _moe_check(jl, tl, jcfg.moe, tcfg.moe,
                                 _np(h), f"moe layer {i}")
        low += n
    return e_over_n * low / (jcfg.n_layers - fk)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(arch, monkeypatch):
    """Per architecture, on the reference's params: the full forward's
    logits and aux; a prefill of L - 1 tokens into a cache and one decode
    step (logits and every cache leaf); and the port's decode logits
    against its own full forward (the reference's ``atol=rtol=2e-2``)."""
    jcfg, tcfg, jp, _, tp = _params(arch, seed=2)
    B, L = 2, 12
    tokens, fe = _inputs(jcfg, B, L)
    prefix = jcfg.vision_tokens if jcfg.family == "vlm" else 0
    seen = []
    real = tmoe.moe_ffn

    def recording(p, h, cfg, **kw):
        seen.append(h.clone())
        return real(p, h, cfg, **kw)

    with torch.no_grad():
        wl, waux, _ = jtf.forward(jp, _j(tokens), jcfg, frontend_inputs=_j(fe))
        monkeypatch.setattr(tmoe, "moe_ffn", recording)
        gl, gaux, gc = ttf.forward(tp, _t(tokens), tcfg,
                                   frontend_inputs=_t(fe))
        monkeypatch.undo()
        assert gc is None
        _close(gl, wl, _bf16_tol(wl), f"{arch} forward logits")
        # nothing dropped at capacity factor 8 (XLA's mean of the keep
        # mask reads 1 + 3e-8 in f32)
        _close(gaux["moe_dropped"], waux["moe_dropped"], 1e-6, "dropped")
        assert float(gaux["moe_dropped"]) == 0.0
        if jcfg.family == "moe":
            bound = _moe_layers_check(jp, tp, jcfg, tcfg, seen)
            _close(gaux["moe_aux"], waux["moe_aux"],
                   1e-3 * float(waux["moe_aux"]) + bound, "moe_aux")
        else:
            assert not seen and float(gaux["moe_aux"]) == 0.0

        max_len = L + prefix
        jc = jtf.init_cache(jcfg, B, max_len)
        tc = ttf.init_cache(tcfg, B, max_len, device="cpu")
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tc.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()}
        head, last = tokens[..., :L - 1], tokens[..., L - 1:]
        wpl, _, jc = jtf.forward(jp, _j(head), jcfg, frontend_inputs=_j(fe),
                                 cache=jc, cache_index=jnp.int32(0))
        gpl, _, gc = ttf.forward(tp, _t(head), tcfg, frontend_inputs=_t(fe),
                                 cache=tc, cache_index=0)
        assert gc is tc
        _close(gpl, wpl, _bf16_tol(wpl), f"{arch} prefill logits")
        for k in jc:
            _close(gc[k], jc[k], _bf16_tol(jc[k]), f"prefill cache {k}")
        wdl, _, jc = jtf.forward(jp, _j(last), jcfg, cache=jc,
                                 cache_index=jnp.int32(prefix + L - 1))
        gdl, _, gc = ttf.forward(tp, _t(last), tcfg, cache=gc,
                                 cache_index=prefix + L - 1)
        _close(gdl, wdl, _bf16_tol(wdl), f"{arch} decode logits")
        for k in jc:
            _close(gc[k], jc[k], _bf16_tol(jc[k]), f"decode cache {k}")
        np.testing.assert_allclose(_np(gdl)[:, -1], _np(gl)[:, -1],
                                   atol=2e-2, rtol=2e-2)


def test_lm_loss():
    rng = np.random.default_rng(8)
    logits = rng.normal(0, 1, (2, 3, 4, 16)).astype(np.float32)
    labels = rng.integers(0, 16, (2, 4, 3)).astype(np.int32)
    mask = (rng.random((2, 4, 3)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jtf.lm_loss(_j(logits), _j(labels), _j(m))
        got = ttf.lm_loss(_t(logits), _t(labels), _t(m))
        _close(got, want, F32_TOL, "audio loss")
    want = jtf.lm_loss(_j(logits[:, :, 0]), _j(labels[:, 0]))
    got = ttf.lm_loss(_t(logits[:, :, 0]), _t(labels[:, 0]))
    _close(got, want, F32_TOL, "loss")
