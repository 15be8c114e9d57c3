"""PyTorch port: the examples (``repro_torch.examples``) held against the
repository's ``examples/*.py`` on the CPU.

Each port example runs through its ``main(["--device", "cpu"])``; each
reference example runs as written (its module loaded from its file, its
entry point wrapped to keep what it returns).  What is compared, and why:

* quickstart and maritime_clustering: the printed lines equal, and
  ``member_of``, ``is_rep`` and ``is_outlier`` equal.  The maritime
  reference runs in one subprocess, where its own ``XLA_FLAGS`` give it 8
  forced host devices, while the port's 8 gloo CPU ranks run (the
  materialize plan, so the reference's fused ``psum`` fault does not
  apply);
* serve_lm: the request and token counts, decode steps, prefill calls and
  padding waste equal (host bookkeeping; the seeded weights differ, so
  the tokens do), and so do the printed lines but for the tokens;
* train_lm: at 12 steps into ``tmp_path`` both runs lower the loss (the
  examples assert it); the port starts from the reference's init of the
  same seed, so its first loss is within ``LAUNCH_TOL`` of the
  reference's (``tests/test_torch_train.py``).
"""
import contextlib
import importlib.util
import io
import logging
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.examples import (maritime_clustering, quickstart, serve_lm,
                                  train_lm)
from test_torch_serve import _counts
from test_torch_train import LAUNCH_TOL, _ref_state_for

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
LABELS = ("member_of", "is_rep", "is_outlier")
PORT = {"quickstart": quickstart, "maritime_clustering": maritime_clustering,
        "serve_lm": serve_lm, "train_lm": train_lm}


def _reference(name: str):
    """The reference example ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keep(monkeypatch, mod, attr: str) -> list:
    """Wrap ``mod.attr`` so that each call's return is appended to the
    list returned."""
    seen, real = [], getattr(mod, attr)

    def call(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]
    monkeypatch.setattr(mod, attr, call)
    return seen


def _same_labels(got, want):
    for f in LABELS:
        assert np.array_equal(getattr(got, f).cpu().numpy(),
                              np.asarray(getattr(want, f))), f


def test_examples_are_all_ported():
    """Every reference example has its port, and no port example lacks its
    reference."""
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(PORT)


def test_quickstart_matches_reference(monkeypatch, capsys):
    ref = _reference("quickstart")
    want = _keep(monkeypatch, ref, "run_dsc")
    ref.main()
    want_lines = capsys.readouterr().out.splitlines()
    out = quickstart.main(["--device", "cpu"])
    got_lines = capsys.readouterr().out.splitlines()
    assert got_lines == want_lines and len(got_lines) > 2
    _same_labels(out.result, want[0].result)


_REF_MARITIME = textwrap.dedent("""
    import contextlib, importlib.util, io, sys
    import numpy as np
    spec = importlib.util.spec_from_file_location("ref_maritime",
                                                  sys.argv[1])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)        # sets XLA_FLAGS before JAX starts
    seen, real = [], mod.run_dsc_distributed
    mod.run_dsc_distributed = lambda *a, **kw: seen.append(
        real(*a, **kw)) or seen[-1]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    r = seen[0].result
    np.savez(sys.argv[2], lines=np.array(buf.getvalue().splitlines()),
             **{f: np.asarray(getattr(r, f))
                for f in ("member_of", "is_rep", "is_outlier")})
""")


def test_maritime_clustering_matches_reference(tmp_path, capsys):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_MARITIME,
         str(EXAMPLES / "maritime_clustering.py"), str(tmp_path / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out = maritime_clustering.main(["--device", "cpu"])
        got_lines = capsys.readouterr().out.splitlines()
        _, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    want = np.load(tmp_path / "ref.npz")
    assert got_lines == list(want["lines"]) and len(got_lines) > 2
    for f in LABELS:
        assert np.array_equal(getattr(out.result, f).numpy(), want[f]), f


def test_serve_lm_matches_reference(monkeypatch, capsys, caplog):
    ref = _reference("serve_lm")
    want = _keep(monkeypatch, ref, "serve_main")
    with caplog.at_level(logging.INFO):
        ref.main()
        want_lines = capsys.readouterr().out.splitlines()
        got = serve_lm.main(["--device", "cpu"])
        got_lines = capsys.readouterr().out.splitlines()
    assert _counts(caplog, "repro_torch.serve") == \
        _counts(caplog, "repro.serve")
    assert len(got) == len(want[0]) == 12
    assert [(r.uid, len(r.out)) for r in got] == \
        [(r.uid, len(r.out)) for r in want[0]]
    strip = lambda lines: [ln.split(":")[0] for ln in lines]
    assert strip(got_lines) == strip(want_lines) and len(got_lines) == 4


def test_train_lm_matches_reference(monkeypatch, tmp_path, capsys):
    ref = _reference("train_lm")
    want = _keep(monkeypatch, ref, "train_main")
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--steps", "12",
                                      "--ckpt-dir", str(tmp_path / "ref")])
    ref.main()
    want_lines = capsys.readouterr().out.splitlines()
    _ref_state_for(monkeypatch)
    got = train_lm.main(["--steps", "12", "--ckpt-dir",
                         str(tmp_path / "port"), "--device", "cpu"])
    got_lines = capsys.readouterr().out.splitlines()
    assert len(got) == len(want[0]) == 12
    assert abs(got[0] - want[0][0]) <= LAUNCH_TOL
    assert np.mean(got[-10:]) < np.mean(got[:10])
    assert got_lines[-1].startswith("OK: loss decreased") and \
        want_lines[-1].startswith("OK: loss decreased")
    assert any((tmp_path / "port").iterdir())


def test_train_lm_default_checkpoints_are_fresh(monkeypatch, tmp_path):
    """Without ``--ckpt-dir`` the run writes into a new temporary
    directory (here under ``tmp_path``), never the reference's fixed
    ``/tmp/repro_train_lm`` (from which a ``--resume`` would start)."""
    monkeypatch.setattr(train_lm.tempfile, "tempdir", str(tmp_path))
    made = []
    real = train_lm.tempfile.mkdtemp
    monkeypatch.setattr(train_lm.tempfile, "mkdtemp",
                        lambda **kw: made.append(real(**kw)) or made[-1])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_lm.main(["--steps", "12", "--device", "cpu"])
    assert len(made) == 1 and Path(made[0]).parent == tmp_path
    assert buf.getvalue().splitlines()[-1].endswith(made[0])
    assert any(Path(made[0]).iterdir())


@pytest.mark.parametrize("name", sorted(PORT))
def test_example_needs_a_card_by_default(name, monkeypatch):
    """``--device`` defaults to the card: without one the example raises
    before any work, and never runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT[name].main([])
