"""PyTorch port: TSA1/TSA2 and the Jaccard kernel's plain version held
against the JAX package.  Packed words travel as int32 bit patterns in the
port and as uint32 in the reference; they compare equal as uint32."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import segmentation as jseg
from repro.core import windows as jwin
from repro.kernels.jaccard.ops import window_jaccard as jwindow_jaccard
from repro.kernels.jaccard.ref import jaccard_ref as jjaccard_ref
from repro_torch.core import segmentation as tseg
from repro_torch.kernels.jaccard.ops import window_jaccard
from repro_torch.kernels.jaccard.ref import jaccard_ref

torch.set_num_threads(1)


def _words_u32(w):
    return np.asarray(w).astype(np.uint32)


def _words_i32(w):
    return torch.from_numpy(np.asarray(w, np.uint32).view(np.int32).copy())


def _masks(seed, T=5, M=23, C=70, density=0.3, valid_frac=0.8):
    rng = np.random.default_rng(seed)
    bits = rng.uniform(size=(T, M, C)) < density
    valid = rng.uniform(size=(T, M)) < valid_frac
    valid[-1] = False                      # an all-padding row
    words = np.asarray(jwin.pack_bits(jnp.asarray(bits)))
    return bits, words, valid


@pytest.mark.parametrize("w", [1, 3, 6])
def test_tsa1(w, fig1):
    batch, _ = fig1
    rng = np.random.default_rng(w)
    valid = np.array(batch.valid)
    nvote = np.where(valid, rng.uniform(size=valid.shape), 0.0).astype(
        np.float32)
    j = jseg.tsa1(jnp.asarray(nvote), jnp.asarray(valid), w, 0.15)
    t = tseg.tsa1(torch.from_numpy(nvote), torch.from_numpy(valid), w, 0.15)
    for f in ("cut", "sub_local", "num_subs"):
        assert np.array_equal(np.asarray(getattr(j, f)),
                              getattr(t, f).numpy()), f
    # window means divide prefix-sum differences, and XLA's cumsum
    # associates differently from PyTorch's serial one: the prefix sums
    # (up to M = 48 here, ulp 3.8e-6) differ by an ulp or two, so the
    # score agrees to 2e-5 (measured: at most 3.8e-6), not bit for bit
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("seed,w", [(0, 2), (2, 23), (3, 40)])
def test_tsa2_plain_and_kernel_match_reference(seed, w):
    """w >= M included; the last row is all padding."""
    _, words, valid = _masks(seed)
    jv = jnp.asarray(valid)
    tv = torch.from_numpy(valid)
    ref = jseg.tsa2(jnp.asarray(words), jv, w, 0.2, 4)
    ref_k = jseg.tsa2(jnp.asarray(words), jv, w, 0.2, 4, use_kernel=True)
    for use_kernel in (False, True):
        t = tseg.tsa2(_words_i32(words), tv, w, 0.2, 4,
                      use_kernel=use_kernel)
        for r in (ref, ref_k):
            for f in ("cut", "sub_local", "num_subs", "score"):
                assert np.array_equal(np.asarray(getattr(r, f)),
                                      getattr(t, f).numpy()), f


@pytest.mark.parametrize("seed,w", [(4, 3), (5, 23), (6, 30)])
def test_plain_k3_matches_pallas_kernel(seed, w):
    _, words, valid = _masks(seed, T=4, M=23, C=40)
    j = np.asarray(jwindow_jaccard(jnp.asarray(words), jnp.asarray(valid),
                                   w=w))
    t = window_jaccard(_words_i32(words), torch.from_numpy(valid), w=w)
    assert np.array_equal(j, t.numpy())


@pytest.mark.parametrize("w", [2, 5])
def test_bit_expanded_oracle(w):
    _, words, _ = _masks(7, T=3, M=12, C=40)
    j = np.asarray(jjaccard_ref(jnp.asarray(words), w))
    t = jaccard_ref(_words_i32(words), w)
    assert np.array_equal(j, t.numpy())
    assert np.array_equal(tseg.tsa2_signal(_words_i32(words), w).numpy(),
                          t.numpy())


def _scenario_words(name):
    """The reference's packed TSA2 words (masked by validity) and validity
    of fig1 or ``ais_like``, from its plain join."""
    from repro.core import geometry as jgeo
    from repro.core import voting as jvote
    from repro.data import synthetic as jsyn
    if name == "fig1":
        jb = jsyn.figure1_scenario(n_per_route=4, points_per_leg=24,
                                   seed=0)[0]
        eps = (0.42, 1.0)
    else:
        jb = jsyn.ais_like(n_vessels=24, max_points=96, seed=1)[0]
        diam, mean_dt = jsyn.default_dsc_params_for(jb)
        eps = (0.15 * diam, mean_dt)
    words = jvote.neighbor_mask_packed(jgeo.subtrajectory_join(jb, jb, *eps))
    valid = np.asarray(jb.valid)
    return np.where(valid[..., None], _words_u32(words), 0), valid


@pytest.mark.parametrize("w", [1, 6, 20])
@pytest.mark.parametrize("case", ["fig1", "ais"])
def test_tsa2_signal_impls_match_reference(case, w):
    """``tsa2_signal(impl=)``: the packed engine and the 32x-expanded
    bit-plane oracle give the reference's ``d`` bit for bit, each equal to
    the other; an unknown name raises the reference's ``ValueError``."""
    words, _ = _scenario_words(case)
    outs = []
    for impl in ("packed", "bitplane"):
        j = np.asarray(jseg.tsa2_signal(jnp.asarray(words), w, impl=impl))
        t = tseg.tsa2_signal(_words_i32(words), w, impl=impl).numpy()
        assert np.array_equal(j, t), impl
        outs.append(t)
    assert np.array_equal(*outs) and bool((outs[0] > 0).any())
    with pytest.raises(ValueError) as jerr:
        jseg.tsa2_signal(jnp.asarray(words), w, impl="dense")
    with pytest.raises(ValueError) as terr:
        tseg.tsa2_signal(_words_i32(words), w, impl="dense")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("interpret", [None, True, False])
def test_window_jaccard_takes_interpret(interpret):
    """The reference's ``interpret`` (Pallas' interpret mode) is taken and
    changes nothing."""
    _, words, valid = _masks(8, T=4, M=23, C=40)
    tw, tv = _words_i32(words), torch.from_numpy(valid)
    assert torch.equal(window_jaccard(tw, tv, w=5, interpret=interpret),
                       window_jaccard(tw, tv, w=5))
