"""What a run may load, read and write, and that it never falls back."""
import json
import re
import subprocess
import sys
import time

import torch

from conftest import ROOT, SEED

from dscbench import harness

PY = [sys.executable, "-c"]


def _modules_after(stmt: str) -> set[str]:
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]; {stmt}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run(PY + [code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    return set(out.stdout.split())


def test_reference_loads_no_program_and_no_jax():
    tops = _modules_after("import dscbench.reference.pipeline, "
                          "dscbench.reference.compare")
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_harness_loads_no_jax_package():
    tops = _modules_after("import dscbench.harness as h, torch; "
                          "h.Program(h.load_cell('brest.dense'), "
                          "torch.device('cpu'))")
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in harness.forbidden_modules()


def test_no_card_fails_without_a_result(tmp_path):
    p = subprocess.run(
        [sys.executable, str(ROOT / "dscbench" / "run.py"), "--workload",
         "brest.dense", "--seed", str(SEED), "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path)})
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_sources_keep_inside_the_checkout():
    for path in (ROOT / "dscbench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "/tmp" not in text and "/dev/shm" not in text, path
        assert not re.search(r"['\"]benchmarks/", text), path


def _result(trace: bool):
    cell = harness.load_cell("brest.dense")
    from conftest import tiny
    cell = tiny(cell)
    cell.traffic = dict(cell.traffic, slices=2)
    res, _ = harness.run_cell(cell, SEED, 0.5, trace, torch.device("cpu"),
                              time.perf_counter())
    return json.loads(json.dumps(res))


def test_result_line_keys():
    res = _result(False)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {"job_ms", "job_ms_p95", "setup_s"}
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(res["device"])


def test_traced_result_line_keys():
    res = _result(True)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert "stage.similarity_ms" in res["metrics"]
