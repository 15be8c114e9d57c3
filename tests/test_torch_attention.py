"""PyTorch port: the attention entry point held against the JAX package.

The same numpy inputs, made from a seed, go through ``repro``'s
``flash_attention_ref`` and through the port's
``flash_attention(device="cpu")`` (its plain version on CPU tensors).  The
Pallas kernel itself is not run: it calls ``pl.load``, which the
installed JAX lacks (``tests/test_flash_attention.py`` fails on it).
Shapes and masks are those of ``tests/test_flash_attention.py`` plus
bfloat16, a fully masked row, and Lq = 1 and 48.  Tolerances and why:

* float32 to ``atol=2e-5, rtol=1e-4`` (the JAX package's own tolerance for
  its kernel): both einsums and the softmax sum in another order;
* bfloat16 to ``atol=1e-3, rtol=1e-2``, compared in float32: both
  einsums return bfloat16 (scores and probabilities rounded to 8 bits), so
  a sum taken in another order can round a score or a probability one
  bfloat16 ulp apart, and the output is rounded to bfloat16 too (one ulp
  is at most 2**-7 = 0.0078 of the value, inside ``rtol``).

The plain mirrors of the CUDA launcher's pieces are held here too: the
tile test (``tile_class_ref``) never skips a pair that the mask keeps and
never calls a tile fully kept that is not; the key split and merge
(``flash_attention_split_ref``) gives ``repro``'s output within the
float32 tolerance above and, in bfloat16, within ``kernel_tolerance``
(it rounds the unnormalised probabilities, as the kernels do).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ref import flash_attention_ref as jref
from repro_torch.kernels.attention import ops as tops
from repro_torch.kernels.attention import ref as tref

torch.set_num_threads(1)
HUGE = tops.HUGE
TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=1e-3, rtol=1e-2)}


def _qkv(seed, B=2, Lq=32, M=32, KV=2, G=3, hd=16, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(0, 1, (B, Lq, KV, G, hd)) * q_scale).astype(np.float32)
    k = rng.normal(0, 1, (B, M, KV, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, M, KV, hd)).astype(np.float32)
    return q, k, v


def _run(q, k, v, qp, kp, dtype, window=None, prefix=None, max_kv=None,
         softcap=None):
    """Port and JAX on the same arrays; both outputs as float32 numpy."""
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    want = jref(*(jnp.asarray(a, jd) for a in (q, k, v)),
                jnp.asarray(qp, jnp.int32), jnp.asarray(kp, jnp.int32),
                HUGE if window is None else window,
                0 if prefix is None else prefix,
                HUGE if max_kv is None else max_kv, softcap=softcap)
    got = tops.flash_attention(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)),
        torch.from_numpy(np.asarray(qp, np.int32)),
        torch.from_numpy(np.asarray(kp, np.int32)), window=window,
        prefix=prefix, max_kv=max_kv, softcap=softcap, device="cpu")
    assert got.dtype == td and got.shape == q.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("Lq,M,KV,G,hd", [
    (32, 32, 2, 3, 16), (64, 64, 1, 8, 32), (16, 64, 4, 1, 8),
    (48, 48, 2, 2, 24)])
def test_causal_matches_jax(Lq, M, KV, G, hd, dtype):
    q, k, v = _qkv(0, Lq=Lq, M=M, KV=KV, G=G, hd=hd, q_scale=hd ** -0.5)
    got, want = _run(q, k, v, np.arange(Lq), np.arange(M), dtype)
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_window_prefix_softcap_matches_jax(dtype):
    q, k, v = _qkv(1, Lq=48, M=48)
    got, want = _run(q, k, v, np.arange(48), np.arange(48), dtype, window=8,
                     prefix=12, softcap=30.0)
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_decode_max_kv_matches_jax(dtype):
    """Lq = 1 attending a bounded cache region."""
    q, k, v = _qkv(2, Lq=1, M=64)
    got, want = _run(q, k, v, [40], np.arange(64), dtype, max_kv=40)
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_fully_masked_rows_average_v(dtype):
    """Queries before every key: each row's keys are all masked, and the
    row returns the mean of v (masked scores are -1e30, not -inf)."""
    q, k, v = _qkv(3, B=1, Lq=5, M=37, KV=2, G=2, hd=8)
    qp = np.arange(5)
    kp = np.arange(37) + 10
    got, want = _run(q, k, v, qp, kp, dtype, window=4)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    td = getattr(torch, dtype)
    mean = torch.from_numpy(v).to(td).float().mean(dim=1)   # [B, KV, hd]
    np.testing.assert_allclose(
        got, np.broadcast_to(mean.numpy()[:, None, :, None, :], got.shape),
        **TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_sliding_window_mixed_rows(dtype):
    """Gemma-2's local layer at small size (softcap 50, window 4) with
    shuffled key positions: rows keep few keys, some none."""
    q, k, v = _qkv(4, B=1, Lq=20, M=24, KV=1, G=2, hd=16, q_scale=0.25)
    rng = np.random.default_rng(4)
    kp = rng.permutation(24) + 3
    got, want = _run(q, k, v, np.arange(20), kp, dtype, window=4,
                     softcap=50.0)
    np.testing.assert_allclose(got, want, **TOL[dtype])


def test_plain_mask_algebra():
    """The mask against a loop over the definition."""
    qp = torch.tensor([0, 3, 7, 12], dtype=torch.int32)
    kp = torch.tensor([0, 2, 3, 5, 8, 11, 12, 13], dtype=torch.int32)
    got = tref.attention_mask(qp, kp, 4, 3, 11)
    for a, x in enumerate(qp.tolist()):
        for b, y in enumerate(kp.tolist()):
            ok = ((x - 4 < y <= x) or (y < 3 and x < 3)) and y <= 11
            assert bool(got[a, b]) == ok, (x, y)


def test_fwd_refuses_bad_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, Lq=4, M=6))
    qp, kp = torch.arange(4, dtype=torch.int32), torch.arange(6,
                                                               dtype=torch.int32)
    with pytest.raises(ValueError, match="do not match"):
        tops.flash_attention_fwd(q, k[:, :, :1], v, qp, kp, HUGE, 0, HUGE)
    with pytest.raises(ValueError, match="no keys"):
        tops.flash_attention_fwd(q, k[:, :0], v[:, :0], qp, kp[:0], HUGE, 0,
                                 HUGE)


def test_no_card_means_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q, k, v = _qkv(6, Lq=4, M=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.flash_attention(q, k, v, np.arange(4), np.arange(4))


@pytest.mark.parametrize("seed", range(8))
def test_tile_mirror_never_skips_a_kept_pair(seed):
    """Random, unsorted positions, windows, prefixes and ``max_kv``, at the
    tile shapes of all three paths."""
    rng = np.random.default_rng(seed)
    Lq, M, G = rng.integers(1, 150), rng.integers(1, 300), rng.integers(1, 4)
    qp = torch.from_numpy(rng.integers(-20, 200, Lq).astype(np.int32))
    kp = torch.from_numpy(rng.integers(-20, 200, M).astype(np.int32))
    if seed % 2:
        qp, kp = qp.sort().values, kp.sort().values.flip(0)
    window = int(rng.choice([HUGE, 1, 5, 40]))
    prefix = int(rng.choice([0, 10, 90]))
    max_kv = int(rng.choice([HUGE, 0, 37, 150]))
    ok = tref.attention_mask(qp, kp, window, prefix, max_kv)
    ok_rows = ok.repeat_interleave(int(G), dim=0)       # row r = query r // G
    for path in tops.PATHS:
        rows, keys = tops.tile_shape(path, 64)
        cls = tref.tile_class_ref(qp, kp, window, prefix, max_kv, G=int(G),
                                  rows=rows, keys=keys)
        r = torch.arange(Lq * int(G))[:, None] // rows
        c = torch.arange(M)[None, :] // keys
        per_pair = cls[r, c]
        assert not bool((ok_rows & (per_pair == 0)).any())
        assert bool(ok_rows[per_pair == 2].all())


SPLIT_CASES = {
    "decode_max_kv": dict(Lq=1, M=90, qp=[60], max_kv=60, softcap=50.0),
    "fully_masked_rows": dict(Lq=12, M=40, qp=np.arange(12),
                              kp=np.arange(40) + 5, window=4),
    "window_softcap": dict(Lq=30, M=30, window=6, softcap=30.0),
    "prefix": dict(Lq=25, M=33, prefix=9),
}


@pytest.mark.parametrize("nsplit", [3, 7])
@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_merge_matches_jax(case, dtype, nsplit):
    """The key split's plain partials and merge against ``repro``'s
    ``flash_attention_ref``."""
    kw = dict(SPLIT_CASES[case])
    Lq, M = kw.pop("Lq"), kw.pop("M")
    qp = np.asarray(kw.pop("qp", np.arange(M - Lq, M)))
    kp = np.asarray(kw.pop("kp", np.arange(M)))
    q, k, v = _qkv(nsplit, B=2, Lq=Lq, M=M, KV=2, G=2, hd=16,
                   q_scale=0.25)
    window, prefix, max_kv = (kw.get("window", HUGE), kw.get("prefix", 0),
                              kw.get("max_kv", HUGE))
    softcap = kw.get("softcap")
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jref(*(jnp.asarray(a, jd) for a in (q, k, v)),
                jnp.asarray(qp, jnp.int32), jnp.asarray(kp, jnp.int32),
                window, prefix, max_kv, softcap=softcap)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    tqp, tkp = (torch.from_numpy(p.astype(np.int32)) for p in (qp, kp))
    got = tref.flash_attention_split_ref(tq, tk, tv, tqp, tkp, window,
                                         prefix, max_kv, softcap, nsplit)
    assert got.dtype == td and got.shape == tq.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL[dtype])
        return
    tol = tref.kernel_tolerance(tq, tk, tv, tqp, tkp, window, prefix, max_kv,
                                softcap, want)
    assert bool(((got.float() - want).abs() <= tol).all())


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_head_dim_320_matches_jax(dtype):
    """Head dims past the fast kernels' 256 (the card's general path)."""
    q, k, v = _qkv(8, B=1, Lq=20, M=20, KV=2, G=2, hd=320,
                   q_scale=320 ** -0.5)
    got, want = _run(q, k, v, np.arange(20), np.arange(20), dtype,
                     window=7)
    np.testing.assert_allclose(got, want, **TOL[dtype])


def test_plan_paths_and_splits():
    """The path by dtype, head dim and alignment; a key split only when
    the blocks cannot fill the card."""
    bf, f = torch.bfloat16, torch.float32
    plan = tops.plan_fwd
    assert plan(1, 4096, 4096, 5, 3, 64, bf).path == "bf16_mma"
    assert plan(1, 4096, 4096, 5, 3, 64, f).path == "f32_tiled"
    assert plan(1, 4096, 4096, 5, 3, 64, f, aligned=False).path == "general"
    assert plan(1, 16, 16, 1, 1, 320, bf).path == "general"
    assert plan(1, 16, 16, 1, 1, 12, bf).path == "general"
    assert plan(1, 4096, 4096, 5, 3, 64, bf).nsplit == 1
    assert plan(1, 8192, 8192, 4, 2, 256, bf).nsplit == 1
    dec = plan(1, 1, 8192, 4, 2, 256, bf)
    assert dec.nsplit > 1 and dec.keys == 32
    assert dec.nsplit * dec.tiles_per_split >= 8192 // 32
    assert (dec.nsplit - 1) * dec.tiles_per_split < 8192 // 32
    assert plan(1, 1, 1, 4, 2, 256, bf).nsplit == 1


@pytest.mark.parametrize("interpret", [None, True, False])
def test_interpret_is_accepted_and_ignored(interpret):
    """The reference's ``interpret`` (Pallas' interpret mode) is taken and
    changes nothing."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3))
    pos = torch.arange(32, dtype=torch.int32)
    base = tops.flash_attention(q, k, v, pos, pos, window=8, device="cpu")
    got = tops.flash_attention(q, k, v, pos, pos, window=8,
                               interpret=interpret, device="cpu")
    assert torch.equal(got, base)
