"""The metrics of the spans inside a stage: a traced run reports each, at
most its stage's; a program without the spans reports none and still runs."""
import json
import time

import pytest
import torch

from conftest import ROOT, SEED, tiny

from dscbench import harness

PARTS = {"segment.table_ms": "stage.segment_ms",
         "similarity.finalize_ms": "stage.similarity_ms",
         "cluster.thresholds_ms": "stage.cluster_ms",
         "cluster.round_loop_ms": "stage.cluster_ms"}


class Unparted(harness.Program):
    """A program whose ``stage_times`` holds the stages alone, as one
    without the spans inside them."""

    def run(self, batch, params, stage_times):
        out = super().run(batch, params, stage_times)
        if stage_times is not None:
            for k in [k for k in stage_times if "." in k]:
                del stage_times[k]
        return out


def _traced(name, program=None):
    cell = tiny(harness.load_cell(name))
    cell.traffic = dict(cell.traffic, slices=2)
    if "slice_seeds" in cell.traffic:
        cell.traffic["slice_seeds"] = cell.traffic["slice_seeds"][:2]
    dev = torch.device("cpu")
    prog = program(cell, dev) if program else None
    res, _ = harness.run_cell(cell, SEED, 0.5, True, dev,
                              time.perf_counter(), program=prog)
    return res


@pytest.mark.parametrize("name", ["brest.dense", "sis.dense"])
def test_traced_run_reports_the_parts(name):
    res = _traced(name)
    assert res["correct"]
    metrics = res["metrics"]
    for part, stage in PARTS.items():
        assert metrics[part]["unit"] == "ms"
        assert 0.0 <= metrics[part]["value"] <= metrics[stage]["value"], part
    both = (metrics["cluster.thresholds_ms"]["value"]
            + metrics["cluster.round_loop_ms"]["value"])
    assert both <= metrics["stage.cluster_ms"]["value"]


def test_program_without_spans_reports_no_part():
    res = _traced("brest.dense", Unparted)
    assert res["correct"]
    assert not set(PARTS) & set(res["metrics"])
    assert set(PARTS.values()) <= set(res["metrics"])


def test_top_k_cell_lists_what_its_traced_run_reads():
    """The program's spans and counters that a traced top-K run reports
    are those whose ``workloads`` in BENCHMARK.json list ``brest.topk``
    (the device readings need the card)."""
    res = _traced("brest.topk")
    assert res["correct"]
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    own = {x["name"]: "brest.topk" in x["workloads"] for x in m["per_layer"]
           if x["source"] in ("program_span", "program_counter")
           and x["name"] != "job.transfer_ms"}
    assert {n for n, listed in own.items() if listed} == \
        {n for n in own if n in res["metrics"]}
    parts = [p for p in PARTS if p in res["metrics"]]
    for part in parts:
        assert 0.0 <= res["metrics"][part]["value"] <= \
            res["metrics"][PARTS[part]]["value"], part
