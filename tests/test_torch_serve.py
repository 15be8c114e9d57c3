"""PyTorch port: the LM serving path (``repro_torch.serve.engine``,
``repro_torch.launch.serve``) held against the JAX package's.

Both engines run on the reference's own params (``params_from_reference``)
with the same requests.  Wave formation, padding and the counters are
host bookkeeping and must be equal.  Greedy tokens follow the margin rule:
a request's token must equal the reference engine's at every step before
the first step whose reference top-1 / top-2 logit gap is at most the
margin (``MARGIN_ULPS`` = 4 bf16 ulps of the largest logit:
the dense models' logits of ``tests/test_torch_models.py`` sit within 1
ulp of the reference's, so two sequences can part only where the two
best logits lie within 2 ulps); after that step the two sequences may
part, and the step is printed.
"""
import logging
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import serve as jlaunch
from repro.models import transformer as jtf
from repro.serve import engine as jeng
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tlaunch
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_reference
from repro_torch.serve import engine as teng

torch.set_num_threads(1)

j_init = jax.jit(jtf.init_model, static_argnums=1)
MARGIN_ULPS = 4


def _tol(logits):
    return MARGIN_ULPS * 2.0 ** (np.floor(np.log2(np.abs(logits).max())) - 7)


def _setup(arch, seed):
    jcfg = jreg.reduced_config(jreg.get_arch(arch))
    tcfg = treg.reduced_config(treg.get_arch(arch))
    jp = j_init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _requests(mod, n, lens, max_new, seed):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=u, prompt=rng.integers(
        0, 256, int(rng.integers(*lens))).astype(np.int32), max_new=max_new)
        for u in range(n)]


def _serve(mod, params, cfg, reqs, n_slots, max_len, monkeypatch=None):
    """Run ``mod``'s engine; with ``monkeypatch``, also record the logits
    each step returns (a [B, V] array per prefill and decode call)."""
    steps = []
    if monkeypatch is not None:
        for name in ("prefill_step", "decode_step"):
            real = getattr(mod, name)

            def rec(*a, _real=real, **kw):
                logits, cache = _real(*a, **kw)
                steps.append(np.asarray(logits, np.float32))
                return logits, cache
            monkeypatch.setattr(mod, name, rec)
    eng = mod.ServeEngine(params, cfg, n_slots=n_slots, max_len=max_len)
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    return eng, {r.uid: r.out for r in done}, steps


def _margin(row):
    top = np.sort(row)[::-1]
    return float(top[0] - top[1])


@pytest.mark.parametrize("arch", ["smollm-360m", "yi-6b"])
def test_engine_matches_reference(arch, monkeypatch):
    """7 requests of 6-12 tokens in 3 slots (waves 3 + 3 + 1, right
    padding): the counters and padding waste equal the reference's, and
    each request's greedy tokens equal the reference engine's under the
    margin rule, on the wave's logits of the reference."""
    jcfg, tcfg, jp, tp = _setup(arch, seed=0)
    args = (7, (6, 13), 5, 0)
    jeng_, jout, jsteps = _serve(jeng, jp, jcfg, _requests(jeng, *args), 3,
                                 48, monkeypatch)
    teng_, tout, _ = _serve(teng, tp, tcfg, _requests(teng, *args), 3, 48)
    for f in ("prefill_calls", "decode_steps", "padding_waste"):
        assert getattr(teng_, f) == getattr(jeng_, f), f
    assert teng_.prefill_calls == 3
    # the reference's waves: the queue sorted by prompt length (stable)
    reqs = sorted(_requests(jeng, *args), key=lambda r: len(r.prompt))
    waves = [reqs[i:i + 3] for i in range(0, 7, 3)]
    call = 0
    tol = _tol(jsteps[0])
    sure = 0
    for wave in waves:
        calls = jsteps[call:call + 5]
        call += 5
        for slot, r in enumerate(wave):
            for step in range(5):
                if _margin(calls[step][slot]) > tol:
                    assert tout[r.uid][step] == jout[r.uid][step], \
                        (r.uid, step)
                    sure += 1
                else:
                    print(f"{arch}: request {r.uid} low margin at step "
                          f"{step}; compared up to it")
                    break
    assert sure >= 10


def test_engine_waves_complete():
    """The reference's wave test on the port: 7 requests of 12 tokens in
    3 slots take 3 prefill calls, and each returns its 5 tokens."""
    _, tcfg, _, tp = _setup("smollm-360m", seed=0)
    eng = teng.ServeEngine(tp, tcfg, n_slots=3, max_len=48)
    rng = np.random.default_rng(0)
    for uid in range(7):
        eng.submit(teng.Request(
            uid=uid, prompt=rng.integers(0, 256, 12).astype(np.int32),
            max_new=5))
    done = eng.run()
    assert len(done) == 7
    assert all(r.done and len(r.out) == 5 for r in done)
    assert eng.prefill_calls == 3 and eng.decode_steps == 12


def test_greedy_matches_forward_chain():
    """One request in one slot (no padding): the engine's greedy tokens
    equal the argmaxes of full forwards over the growing sequence (fed the
    engine's tokens) wherever that forward's top-1 / top-2 gap is above
    the tolerance: the cache path against the cacheless one."""
    _, tcfg, _, tp = _setup("yi-6b", seed=1)
    prompt = np.random.default_rng(1).integers(0, 256, 10).astype(np.int32)
    eng = teng.ServeEngine(tp, tcfg, n_slots=1, max_len=32)
    eng.submit(teng.Request(uid=0, prompt=prompt, max_new=6))
    out = eng.run()[0].out
    sure = 0
    for t in range(6):
        seq = torch.from_numpy(np.concatenate([prompt, out[:t]]))[None]
        with torch.no_grad():
            logits = ttf.forward(tp, seq.int(), tcfg)[0][0, -1].numpy()
        if _margin(logits) > _tol(logits):
            assert int(np.argmax(logits)) == out[t], t
            sure += 1
    assert sure >= 3


def test_sampler_matches_reference():
    """Temperature sampling is the reference's numpy sampler: the same
    seed and logits give the same tokens (and greedy the argmax)."""
    jcfg, tcfg, jp, tp = _setup("smollm-360m", seed=0)
    logits = np.random.default_rng(4).normal(0, 1, (20, 256))
    logits = logits.astype(np.float32)
    for temp in (0.0, 0.7):
        j = jeng.ServeEngine(jp, jcfg, n_slots=1, max_len=8,
                             temperature=temp, seed=3)
        t = teng.ServeEngine(tp, tcfg, n_slots=1, max_len=8,
                             temperature=temp, seed=3)
        assert [t._sample(r) for r in logits] == \
            [j._sample(r) for r in logits]


def test_prefill_last_positions():
    """``last_positions`` picks each row's true last prompt position."""
    _, tcfg, _, tp = _setup("smollm-360m", seed=0)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 9)).astype(np.int32))
    cache = ttf.init_cache(tcfg, 2, 16, device="cpu")
    got, c2 = teng.prefill_step(tp, tok, cache, tcfg,
                                last_positions=torch.tensor([3, 8]))
    assert c2 is cache
    with torch.no_grad():
        full = ttf.forward(tp, tok, tcfg, cache=ttf.init_cache(
            tcfg, 2, 16, device="cpu"), cache_index=0)[0]
    torch.testing.assert_close(got[0], full[0, 3], rtol=0, atol=0)
    torch.testing.assert_close(got[1], full[1, 8], rtol=0, atol=0)


_LINE = re.compile(r"served (\d+) requests, (\d+) tokens in .*; (\d+) decode "
                   r"steps, (\d+) prefill calls, padding waste ([\d.]+)")


def _counts(caplog, logger):
    line = [r.getMessage() for r in caplog.records
            if r.name == logger and "served" in r.getMessage()][-1]
    return _LINE.search(line).groups()


@pytest.mark.parametrize("argv", [[], ["--slots", "3", "--requests", "7",
                                       "--max-new", "5"]])
def test_launcher_matches_reference(argv, caplog):
    """The port's launcher on the CPU gives the reference launcher's
    request and token counts, decode steps, prefill calls and padding
    waste (host bookkeeping: none depends on the weights)."""
    with caplog.at_level(logging.INFO):
        tdone = tlaunch.main(["--arch", "smollm-360m", *argv,
                              "--device", "cpu"])
        jdone = jlaunch.main(["--arch", "smollm-360m", *argv])
    assert len(tdone) == len(jdone)
    assert sorted(len(r.out) for r in tdone) == \
        sorted(len(r.out) for r in jdone)
    assert _counts(caplog, "repro_torch.serve") == \
        _counts(caplog, "repro.serve")


def test_launcher_refusals(monkeypatch, caplog):
    """Audio is refused as in the reference, vlm warns; the default device
    is the card, and without one the launcher raises."""
    with pytest.raises(SystemExit, match="audio"):
        tlaunch.main(["--arch", "musicgen-large", "--device", "cpu"])
    with caplog.at_level(logging.WARNING):
        done = tlaunch.main(["--arch", "paligemma-3b", "--device", "cpu",
                             "--requests", "2", "--max-new", "2"])
    assert len(done) == 2 and "text-only" in caplog.text
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "smollm-360m"])
