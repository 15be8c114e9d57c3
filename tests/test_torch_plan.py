"""PyTorch port: ``EnginePlan``, the DSC run configurations and
``segmentation.segment`` held against the JAX package.

A plan file is one format for both packages: every field, default,
validation message and the JSON form are the reference's, so a plan
saved by either package loads in the other with an equal ``to_dict``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import plan as jplan
from repro.core import segmentation as jseg
from repro.core import windows as jwin
from repro_torch.configs import registry as treg
from repro_torch.core import plan as tplan
from repro_torch.core import segmentation as tseg

torch.set_num_threads(1)

# plans that set every field away from its default, and one per group
EVERY_FIELD = dict(mode="fused", use_kernel=True, use_index=True,
                   fused_rows=64, fused_bc=8, fused_bm=256,
                   seg_use_kernel=True, sim_mode="topk", sim_topk=64,
                   sim_panel=256, sim_strategy="allgather", sim_dtype="bf16",
                   halo_stream="ring", sim_exchange="ring",
                   cluster_engine="sequential", cluster_use_kernel=True,
                   cluster_bu=16, cluster_bs=256)
PLANS = {"default": {}, "every_field": EVERY_FIELD,
         "kernels": dict(use_kernel=True, seg_use_kernel=True,
                         cluster_use_kernel=True),
         "fused_topk": dict(mode="fused", sim_mode="topk", sim_topk=8),
         "tiles_only": dict(fused_rows=32, cluster_bs=64)}


def test_fields_and_defaults_match_reference():
    """Same field names in the same order, with the same defaults."""
    jf = [(f.name, f.default) for f in dataclasses.fields(jplan.EnginePlan)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tplan.EnginePlan)]
    assert tf == jf
    assert len(tf) == 18


@pytest.mark.parametrize("name", sorted(PLANS))
def test_json_round_trips_both_ways(name, tmp_path):
    """reference -> port and port -> reference, in memory and through a
    saved file; the properties agree too."""
    jp = jplan.EnginePlan(**PLANS[name]).validate()
    tp = tplan.EnginePlan(**PLANS[name]).validate()
    assert tp.to_json() == jp.to_json()
    assert tplan.EnginePlan.from_json(jp.to_json()).to_dict() == jp.to_dict()
    assert jplan.EnginePlan.from_json(tp.to_json()).to_dict() == tp.to_dict()
    jp.save(tmp_path / "ref.json")
    tp.save(tmp_path / "port.json")
    assert (tmp_path / "ref.json").read_text() == \
        (tmp_path / "port.json").read_text()
    assert tplan.EnginePlan.load(tmp_path / "ref.json") == tp
    assert jplan.EnginePlan.load(tmp_path / "port.json") == jp
    assert tp.fused_tiles == jp.fused_tiles
    assert tp.cluster_tiles == jp.cluster_tiles
    assert hash(tp) == hash(tplan.EnginePlan.from_dict(tp.to_dict()))


def test_from_dict_refuses_unknown_keys():
    d = dict(tplan.EnginePlan().to_dict(), from_the_future=1)
    with pytest.raises(ValueError) as te:
        tplan.EnginePlan.from_dict(d)
    with pytest.raises(ValueError) as je:
        jplan.EnginePlan.from_dict(d)
    assert str(te.value) == str(je.value)
    assert tplan.EnginePlan.from_dict({"mode": "fused"}) == \
        tplan.EnginePlan(mode="fused")


LEGACY = [dict(), dict(mode="fused"), dict(use_kernel=True),
          dict(use_index=True), dict(fused_tiles=(64, 8, 256)),
          dict(seg_use_kernel=True), dict(cluster_engine="sequential"),
          dict(cluster_use_kernel=True), dict(sim_mode="topk"),
          dict(sim_topk=16), dict(sim_panel=64),
          dict(sim_strategy="allgather"), dict(sim_dtype="bf16"),
          dict(halo_stream="ring"), dict(sim_exchange="ring")]


@pytest.mark.parametrize("kw", LEGACY, ids=lambda kw: ",".join(kw) or "none")
def test_from_legacy_matches_reference(kw):
    assert tplan.EnginePlan.from_legacy(**kw).to_dict() == \
        jplan.EnginePlan.from_legacy(**kw).to_dict()


BAD = [dict(mode="stream"), dict(cluster_engine="greedy"),
       dict(sim_mode="sparse"), dict(sim_strategy="ring"),
       dict(sim_dtype="f16"), dict(halo_stream="ppermute"),
       dict(sim_exchange="psum"), dict(fused_rows=0), dict(sim_topk=-1),
       dict(sim_panel=1.5), dict(fused_bc=0), dict(fused_bm=None),
       dict(cluster_bu=-2), dict(cluster_bs="128")]


@pytest.mark.parametrize("kw", BAD, ids=lambda kw: next(iter(kw)))
def test_validate_messages_match_reference(kw):
    with pytest.raises(ValueError) as te:
        tplan.EnginePlan(**kw).validate()
    with pytest.raises(ValueError) as je:
        jplan.EnginePlan(**kw).validate()
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match=str(je.value).split(" got")[0]):
        tplan.EnginePlan().replace(**kw)


def test_resolve_plan_default():
    assert tplan.resolve_plan(None) == tplan.EnginePlan()
    p = tplan.EnginePlan(mode="fused")
    assert tplan.resolve_plan(p) is p


def test_dsc_configs_match_reference():
    assert sorted(treg.DSC_CONFIGS) == sorted(jreg.DSC_CONFIGS)
    for name, jc in jreg.DSC_CONFIGS.items():
        tc = treg.get_dsc_config(name)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
    assert [f.name for f in dataclasses.fields(treg.DSCRunConfig)] == \
        [f.name for f in dataclasses.fields(jreg.DSCRunConfig)]


def _signal_inputs(seed, T=6, M=40, C=50):
    rng = np.random.default_rng(seed)
    valid = rng.uniform(size=(T, M)) < 0.85
    valid[-1] = False                      # an all-padding row
    nvote = np.where(valid, rng.uniform(size=(T, M)), 0.0).astype(np.float32)
    bits = rng.uniform(size=(T, M, C)) < 0.3
    words = np.asarray(jwin.pack_bits(jnp.asarray(bits)))
    return nvote, words, valid


@pytest.mark.parametrize("name,use_kernel", [("tsa1", False),
                                             ("tsa2", False),
                                             ("tsa2", True)])
def test_segment_matches_reference(name, use_kernel):
    """``segment`` dispatches as the reference's: cuts, slot ids and counts
    equal; TSA2's score bitwise, TSA1's to 2e-5 (its prefix sums associate
    differently from XLA's, as ``tests/test_torch_segmentation.py::
    test_tsa1`` states)."""
    nvote, words, valid = _signal_inputs(3)
    kw = dict(w=4, tau=0.15, max_subs=4, use_kernel=use_kernel)
    j = jseg.segment(name, norm_vote=jnp.asarray(nvote),
                     packed_masks=jnp.asarray(words),
                     valid=jnp.asarray(valid), **kw)
    t = tseg.segment(name, norm_vote=torch.from_numpy(nvote),
                     packed_masks=torch.from_numpy(
                         np.asarray(words, np.uint32).view(np.int32).copy()),
                     valid=torch.from_numpy(valid), **kw)
    for f in ("cut", "sub_local", "num_subs"):
        assert np.array_equal(np.asarray(getattr(j, f)),
                              getattr(t, f).numpy()), f
    assert bool(t.cut.any())
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score), rtol=0,
                               atol=0 if name == "tsa2" else 2e-5)


def test_segment_unknown_name():
    with pytest.raises(ValueError) as te:
        tseg.segment("tsa3", valid=torch.zeros((1, 1), dtype=torch.bool))
    with pytest.raises(ValueError) as je:
        jseg.segment("tsa3", valid=jnp.zeros((1, 1), bool))
    assert str(te.value) == str(je.value) == "unknown segmentation 'tsa3'"


LEGACY_CASES = [{}, dict(sim_mode="topk", sim_topk=4),
                dict(mode="fused", use_kernel=True, seg_use_kernel=True,
                     cluster_use_kernel=True, fused_tiles=(64, 32, 128)),
                dict(cluster_engine="sequential", sim_panel=64,
                     halo_stream="ring", sim_exchange="ring")]


@pytest.mark.parametrize("kw", LEGACY_CASES)
def test_resolve_plan_legacy_flags_match_reference(kw):
    """``resolve_plan(None, **legacy)`` materializes the reference's plan;
    with a plan, the default flags (and None) pass."""
    got = tplan.resolve_plan(None, **kw)
    assert got.to_dict() == jplan.resolve_plan(None, **kw).to_dict()
    p = tplan.EnginePlan(mode="fused")
    defaults = {k: v for k, v in tplan._LEGACY_DEFAULTS.items()}
    assert tplan.resolve_plan(p, **defaults) is p
    assert tplan._LEGACY_DEFAULTS == jplan._LEGACY_DEFAULTS


@pytest.mark.parametrize("kw,exc", [
    (dict(sim_mode="topk"), ValueError),
    (dict(use_kernel=True, sim_topk=8), ValueError),
    (dict(warp_drive=True), TypeError)])
def test_resolve_plan_legacy_errors_match_reference(kw, exc):
    """A plan with a non-default flag, or an unknown flag: the reference's
    exception and message."""
    msgs = []
    for mod in (tplan, jplan):
        with pytest.raises(exc) as e:
            mod.resolve_plan(mod.EnginePlan(), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
