"""PyTorch port: the single-device launcher held against the JAX package's.

``repro_torch.launch.run_dsc.main(argv + ["--device", "cpu"])`` and
``repro.launch.run_dsc.main(argv)`` run the same config, data and plan
file: cluster summaries (clusters, outliers, ``num_clusters``) equal;
``sscr``, ``rmse``, ``alpha`` and ``k`` within the 1e-5 relative
tolerance ``tests/test_torch_dsc.py::_compare`` states (float32 sums in
another order than XLA's).  The parser is the reference's plus
``--device`` and ``--comm``; the resilient runner's and the streaming
service's options give the reference's exit codes (0, 3-8) and cluster
counts; ``--distributed`` runs the multi-device program with the
reference's cluster, member and outlier counts; its resilient options
exit through the parser.
"""
import argparse
import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.dsc import cluster_summary as jsummary
from repro.core.plan import EnginePlan as JPlan
from repro.launch import run_dsc as jl
from repro_torch.core.dsc import cluster_summary as tsummary
from repro_torch.core.plan import EnginePlan
from repro_torch.launch import run_dsc as tl

torch.set_num_threads(1)

README = Path(__file__).resolve().parents[1] / "README.md"
KERNELS = dict(seg_use_kernel=True, cluster_use_kernel=True)
PLANS = {"materialize": dict(use_kernel=True, **KERNELS),
         "fused": dict(mode="fused", **KERNELS),
         "fused_topk": dict(mode="fused", sim_mode="topk", **KERNELS)}


@pytest.mark.parametrize("plan", [None, *sorted(PLANS)])
def test_main_matches_reference(plan, tmp_path, caplog):
    """The default plan (no ``--plan``) and three plan files written by the
    port's ``EnginePlan.save``; the port logs the reference's summary."""
    argv = ["--config", "dsc_synth"]
    if plan is not None:
        path = tmp_path / "plan.json"
        EnginePlan(**PLANS[plan]).save(path)
        argv += ["--plan", str(path)]
    jo = jl.main(argv)
    with caplog.at_level(logging.INFO, logger="repro_torch"):
        to = tl.main(argv + ["--device", "cpu"])
    js, ts = jsummary(jo), tsummary(to)
    for f in ("clusters", "outliers", "num_clusters"):
        assert ts[f] == js[f], f
    for f in ("sscr", "rmse", "alpha", "k"):
        np.testing.assert_allclose(ts[f], js[f], rtol=1e-5, err_msg=f)
    assert ts["num_clusters"] >= 1
    assert (to.sim is None) == (plan == "fused_topk")
    assert (to.join is None) == (plan in ("fused", "fused_topk"))
    assert f"DSC: {ts['num_clusters']} clusters, {len(ts['outliers'])} " \
        "outliers" in caplog.text


@pytest.mark.parametrize("name", ["dsc_synth", "dsc_brest"])
def test_make_dataset_matches_reference(name):
    jb = jl.make_dataset(name, 12, 32, seed=3)
    tb = tl.make_dataset(name, 12, 32, seed=3, device="cpu")
    for f in ("x", "y", "t", "valid", "traj_id"):
        assert np.array_equal(np.asarray(getattr(jb, f)),
                              getattr(tb, f).numpy()), f


def _options(ap):
    return {s: (a.default, tuple(a.choices or ()), a.nargs, a.const,
                type(a).__name__)
            for a in ap._actions for s in a.option_strings}


def test_parser_is_the_reference_plus_device():
    """Option strings, defaults, choices and kinds equal the reference's,
    plus ``--device {cuda,cpu}`` (default ``cuda``) and ``--comm
    {nccl,gloo}`` (no default: ``--distributed`` requires it)."""
    t, j = _options(tl.build_parser()), _options(jl.build_parser())
    assert set(t) - set(j) == {"--device", "--comm"}
    assert t["--comm"][:2] == (None, ("nccl", "gloo"))
    assert set(j) <= set(t)
    for s in j:
        assert t[s] == j[s], s
    assert t["--device"][:2] == ("cuda", ("cuda", "cpu"))
    assert tl._LEGACY_FLAGS == jl._LEGACY_FLAGS


REFUSED = {"elastic_resume": (["--elastic-resume"],
                              "--elastic-resume needs --resume-dir and "
                              "--distributed"),
           "comm": (["--distributed", "2"], "needs --comm")}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_options_refuse(name, capsys):
    """Options that cannot go together exit through the parser (code 2)
    before any data is made: ``--elastic-resume`` without
    ``--resume-dir`` and ``--distributed`` with the reference's own parser
    error, ``--distributed`` without ``--comm`` naming the missing
    transport."""
    argv, msg = REFUSED[name]
    with pytest.raises(SystemExit) as e:
        tl.main(["--device", "cpu", *argv])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert msg in err and argv[0] in err
    if name == "elastic_resume":
        with pytest.raises(SystemExit) as e:
            jl.main(argv)
        assert e.value.code == 2
        assert err.split("error: ")[1] == \
            capsys.readouterr().err.split("error: ")[1]


# the resilient runner's and the streaming service's options, each a
# sequence of launcher calls ("{dir}" is a directory of the package's
# own) and the exit code each must give, the reference's
N12 = ["--n-trajs", "12"]
STREAM = ["--stream", *N12, "--stream-batch-size", "48"]
PORTED = {
    "resume_dir": [(["--resume-dir", "{dir}", "--fault-plan", "{crash}"], 6),
                   (["--resume-dir", "{dir}"], 0)],
    "fault_plan": [(["--fault-plan", "{transient}", "--max-retries", "1"],
                    5)],
    "corruption": [(["--resume-dir", "{dir}", "--fault-plan", "{corrupt}"],
                    6),
                   (["--resume-dir", "{dir}", "--on-corruption", "fail"], 4),
                   (["--resume-dir", "{dir}", "--sync-saves"], 0)],
    "on_overflow": [(["--sim-mode", "topk", "--sim-topk", "2",
                      "--on-overflow", "raise"], 3),
                    (["--sim-mode", "topk", "--sim-topk", "2",
                      "--on-overflow", "widen"], 0),
                    (["--sim-mode", "topk", "--sim-topk", "2",
                      "--on-overflow", "degrade"], 0)],
    "rebalance": [(["--rebalance", "apply"], 0)],
    "stream": [(STREAM, 0)],
    "stream_resume": [([*STREAM, "--resume-dir", "{dir}", "--fault-plan",
                        "{stream_crash}"], 6),
                      ([*STREAM, "--resume-dir", "{dir}"], 0)],
    "stream_poison": [([*STREAM, "--on-dirty", "fail", "--fault-plan",
                        "{poison}"], 7)],
    "stream_backpressure": [([*STREAM, "--backpressure", "block",
                              "--queue-cap", "10"], 8)],
}
FAULT_PLANS = {"crash": {"crash_at": "cluster"},
               "transient": {"transient_at": "segment",
                             "transient_count": 9},
               "corrupt": {"corrupt_stage": "segment",
                           "crash_at": "similarity"},
               "stream_crash": {"crash_at_advance": 3},
               "poison": {"stream_poison": [[1, 3]]}}


def _launch(main, argv):
    """``(exit code, returned value)`` of one in-process launcher call."""
    try:
        return 0, main(argv)
    except SystemExit as e:
        return e.code, None


def _counts(text: str, what: str) -> list[str]:
    """The launcher's summary log lines, without their timing."""
    return [line.split(what, 1)[1].rsplit(" in ", 1)[0]
            for line in text.splitlines() if what in line]


@pytest.mark.parametrize("name", sorted(PORTED))
def test_ported_options_run(name, tmp_path, caplog):
    """Each option now runs through the port's launcher on the CPU: the
    reference's exit code at every call, and the cluster counts it logs
    (a batch run's clusters and outliers, a stream's advances, objects,
    points, reps and outliers, and its books) equal the reference's
    launcher's on the same argv."""
    paths = {}
    for k, plan in FAULT_PLANS.items():
        paths[k] = str(tmp_path / f"{k}.json")
        Path(paths[k]).write_text(json.dumps(plan))
    for step, (argv, code) in enumerate(PORTED[name]):
        logs = {}
        for pkg, main, extra in (("reference", jl.main, []),
                                 ("port", tl.main, ["--device", "cpu"])):
            args = [a.format(dir=str(tmp_path / pkg), **paths)
                    for a in argv]
            caplog.clear()
            with caplog.at_level(logging.INFO):
                got, out = _launch(main, args + extra)
            assert got == code, (pkg, step, args)
            logs[pkg] = caplog.text
        for what in ("DSC: ", "stream: ", "accounting: ", "resilient run: "):
            assert _counts(logs["port"], what) == \
                _counts(logs["reference"], what), (step, what)
        if code == 0:
            assert _counts(logs["port"], "DSC: ") or _counts(
                logs["port"], "stream: ")


@pytest.fixture(scope="module")
def elastic_codes(tmp_path_factory):
    """``tests/test_elastic.py::launcher_codes`` on the port's launcher
    (``--device cpu --comm gloo``, P = 4 written, P = 2 resumed): each
    call's exit code and standard error."""
    import os
    import subprocess
    import sys
    tmp = tmp_path_factory.mktemp("elastic_cli")
    crash = tmp / "crash.json"
    crash.write_text(json.dumps({"crash_at": "cluster"}))
    ckpt = str(tmp / "ckpt")
    env = dict(os.environ, PYTHONPATH=str(README.parent / "src"))

    def run(extra):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.run_dsc", "--device",
             "cpu", "--n-trajs", "24", "--comm", "gloo", *extra], env=env,
            capture_output=True, text=True, timeout=600)
        return proc.returncode, proc.stderr

    return {"crash4": run(["--distributed", "4", "--resume-dir", ckpt,
                           "--fault-plan", str(crash)]),
            "noflag2": run(["--distributed", "2", "--resume-dir", ckpt]),
            "elastic2": run(["--distributed", "2", "--resume-dir", ckpt,
                             "--elastic-resume"]),
            "elastic_alone": run(["--elastic-resume"])}


@pytest.mark.parametrize("case", ["crash4", "noflag2", "elastic2",
                                  "elastic_alone"])
def test_launcher_elastic_exit_codes(elastic_codes, case):
    """The reference's ``test_launcher_elastic_exit_codes`` on the port: an
    injected crash at P = 4 exits 6; a P = 2 resume without the flag is a
    plain error naming ``elastic``; with ``--elastic-resume`` it exits 0;
    ``--elastic-resume`` alone is a usage error (2)."""
    code, err = elastic_codes[case]
    if case == "crash4":
        assert code == tl.EXIT_CODES["injected_crash"], err[-2000:]
    elif case == "noflag2":
        assert code not in (0, tl.EXIT_CODES["injected_crash"])
        assert "elastic" in err
    elif case == "elastic2":
        assert code == tl.EXIT_CODES["ok"], err[-2000:]
        assert "resilient run: resumed_from=2" in err
    else:
        assert code == 2


@pytest.mark.parametrize("mode", ["materialize", "fused"])
def test_distributed_main_matches_reference(mode, caplog):
    """``--distributed 4 --model-par 2 --device cpu --comm gloo`` (eight
    gloo ranks), in materialize and in fused mode, logs the cluster,
    member and outlier counts of the reference's launcher in materialize
    mode under eight forced host devices (the reference's fused run is
    wrong at two model ranks, ROADMAP Queue 3)."""
    import os
    import subprocess
    import sys
    argv = ["--config", "dsc_synth", "--distributed", "4", "--model-par",
            "2"]
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=8", PYTHONPATH=str(README.parent / "src"))
    ref = subprocess.run([sys.executable, "-m", "repro.launch.run_dsc",
                          *argv], env=env, capture_output=True, text=True,
                         timeout=600)
    assert ref.returncode == 0, ref.stderr[-3000:]
    what = "distributed DSC (4 partitions x 2 model): "
    want = _counts(ref.stderr + ref.stdout, what)
    with caplog.at_level(logging.INFO, logger="repro_torch"):
        out = tl.main(argv + ["--mode", mode, "--device", "cpu", "--comm",
                              "gloo"])
    got = _counts(caplog.text, what)
    assert got == want and len(want) == 1, (got, want)
    assert out.vote.shape[0] == 4 and out.sim_diag.shape == (4, 4)


def test_plan_plus_legacy_flag_refuses(tmp_path, capsys):
    path = tmp_path / "plan.json"
    EnginePlan(mode="fused").save(path)
    with pytest.raises(SystemExit) as e:
        tl.main(["--device", "cpu", "--plan", str(path), "--sim-mode",
                 "topk"])
    assert e.value.code == 2
    assert "--plan cannot be combined" in capsys.readouterr().err
    ap = tl.build_parser()
    args = ap.parse_args(["--plan", str(path)])
    assert tl.plan_from_args(args, ap) == EnginePlan(mode="fused")


def test_reference_plan_file_drives_the_port(tmp_path):
    """A plan saved by the reference is what the port's launcher runs."""
    path = tmp_path / "plan.json"
    JPlan(mode="fused", sim_mode="topk", sim_topk=4, fused_rows=64).save(path)
    ap = tl.build_parser()
    plan = tl.plan_from_args(ap.parse_args(["--plan", str(path)]), ap)
    assert plan.to_dict() == JPlan.load(path).to_dict()


@pytest.mark.parametrize("argv", [[], ["--mode", "fused", "--use-kernel",
                                       "--seg-use-kernel",
                                       "--cluster-use-kernel"],
                                  ["--sim-mode", "topk", "--sim-topk", "8",
                                   "--halo-stream", "ring"]])
def test_legacy_flags_make_the_reference_plan(argv):
    tap, jap = tl.build_parser(), jl.build_parser()
    tp = tl.plan_from_args(tap.parse_args(argv), tap)
    jp = jl.plan_from_args(jap.parse_args(argv), jap)
    assert tp.to_dict() == jp.to_dict()


def test_exit_codes_match_reference():
    from repro.run import EXIT_CODES
    assert tl.EXIT_CODES == EXIT_CODES
    for exc in (RuntimeError("sim_topk=4 truncated a potential alpha-edge "
                             "on 3 rows (spill >= alpha)"),
                RuntimeError("CUDA launch failed"), ValueError("sim_topk"),
                KeyError("dsc_nowhere")):
        assert tl._exit_code_for(exc) == jl._exit_code_for(exc), exc
    assert tl._exit_code_for(RuntimeError("sim_topk=4")) == 3


def test_default_device_is_the_card(monkeypatch):
    """Without ``--device`` the launcher runs on the card: with none it
    raises, and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.main(["--config", "dsc_synth"])


def test_readme_cli_table_in_sync(capsys):
    """The README's port table equals the parser's (``--check-readme``),
    and the reference's table beside it is not the port's."""
    assert tl.check_readme_cli_table(str(README)) == []
    assert tl.main(["--check-readme", str(README)]) is None
    assert "CLI table in sync" in capsys.readouterr().out
    assert tl.main(["--print-cli-table"]) is None
    table = capsys.readouterr().out
    assert table == tl.cli_reference_table()
    assert "`--device` `{cuda,cpu}`" in table
    assert jl.readme_cli_table(str(README)) != tl.readme_cli_table(
        str(README))


def test_cli_table_rows_cover_every_flag():
    rows = tl.cli_reference_table().splitlines()[2:]
    flags = [a for a in tl.build_parser()._actions if a.option_strings
             and not isinstance(a, argparse._HelpAction)]
    assert len(rows) == len(flags)
