"""BENCHMARK.json and the files its cells name."""
import json
import re
import shutil
import time

import torch

from conftest import ROOT, SEED, tiny

from dscbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys_names_and_units():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in m["configs"]]
    names += [w["name"] for w in m["workloads"]]
    names += [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    assert len(names) == len(set(names))
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]), x
        assert x["better"] in ("lower", "higher")
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    e2e = {x["name"] for x in m["end_to_end"]}
    for x in m["per_layer"]:
        assert x["moves"] in e2e
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    texts = [c[k] for c in m["configs"] for k in ("why", "source")]
    texts += [w["why"] for w in m["workloads"]] + [x["layer"]
                                                   for x in m["per_layer"]]
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(m)) < 64 * 1024


def test_every_path_is_the_benchmarks_own():
    m = manifest()
    assert m["paths"] == ["dscbench"]
    assert m["command"][:2] == ["python3", "dscbench/run.py"]


def test_cells_resolve_their_files_by_name():
    m = manifest()
    configs = {c["name"]: c for c in m["configs"]}
    for w in m["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.spec["config"] == w["config"]
        assert cell.spec["traffic"] == w["traffic"]
        assert cell.chips == w["chips"] == 1
        assert configs[w["config"]]["file"] == \
            f"dscbench/configs/{w['config']}.json"
        cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert cfg["reduced"] == configs[w["config"]]["reduced"]
        assert cfg["source"] == configs[w["config"]]["source"]
    assert sorted(w["name"] for w in m["workloads"]) == harness.cell_names()


TRAFFIC_KEYS = {"plan", "loop", "rate_per_s", "slices", "slice_seeds",
                "warmup_jobs_per_slice", "trace_jobs", "why"}


def test_traffic_files_and_their_keys():
    """Every traffic file loads through the check and holds only known
    keys; fixed slices are one seed a slice."""
    for path in sorted((ROOT / "dscbench" / "workloads").glob("*.json")):
        traffic = harness.check_traffic(json.loads(path.read_text()),
                                        path.stem)
        assert set(traffic) <= TRAFFIC_KEYS, path
        if "slice_seeds" in traffic:
            assert len(traffic["slice_seeds"]) == traffic["slices"]
    for w in manifest()["workloads"]:
        traffic = harness.load_cell(w["name"]).traffic
        assert set(traffic) <= TRAFFIC_KEYS, w["name"]


def test_metrics_have_readers_and_cells_report_them():
    m = manifest()
    readers = harness.metric_readers()
    for x in m["end_to_end"]:
        assert readers[x["name"]].KIND == "end_to_end"
        assert readers[x["name"]].UNIT == x["unit"]
    for x in m["per_layer"]:
        assert readers[x["name"]].KIND == "per_layer"
        assert readers[x["name"]].UNIT == x["unit"]
    cells = {w["name"] for w in m["workloads"]}
    for w in m["workloads"]:
        cell = harness.load_cell(w["name"])
        for x in m["end_to_end"]:
            if w["name"] in x.get("workloads", [w["name"]]):
                assert x["name"] in cell.spec["end_to_end"]
    for x in m["end_to_end"] + m["per_layer"]:
        assert set(x.get("workloads", [])) <= cells, x["name"]


def test_a_dropped_in_cell_is_found_and_runs(tmp_path):
    """An open-loop cell from two new files, run whole on the CPU: the
    jobs due inside the window at ``rate_per_s``, every one checked."""
    base = tmp_path / "dscbench"
    shutil.copytree(ROOT / "dscbench", base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (base / "workloads" / "open_jobs.json").write_text(json.dumps(
        {"plan": "fused_dense", "loop": "open", "rate_per_s": 4.0,
         "slices": 2, "warmup_jobs_per_slice": 1}))
    (base / "cells" / "brest.open.json").write_text(json.dumps(
        {"config": "dsc_brest", "traffic": "open_jobs", "chips": 1,
         "end_to_end": ["job_ms", "setup_s"], "checks": {"labels": 0}}))
    assert "brest.open" in harness.cell_names(base)
    cell = tiny(harness.load_cell("brest.open", base))
    t0 = time.perf_counter()
    res, _ = harness.run_cell(cell, SEED, 1.0, False, torch.device("cpu"),
                              t0)
    assert res["correct"] and res["attempted"] == 4 and res["failed"] == 0
    assert set(res["metrics"]) == {"job_ms", "setup_s"}
