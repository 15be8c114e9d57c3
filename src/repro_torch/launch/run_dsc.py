"""DSC launcher of the port: the pipeline end to end on synthetic data, on
one device or on a mesh of ranks (counterpart of ``repro.launch.run_dsc``).

``python -m repro_torch.launch.run_dsc --config dsc_brest --n-trajs 4096
--segmentation tsa2 --plan plan.json [--device cpu]``

``python -m repro_torch.launch.run_dsc --config dsc_synth --distributed 4
--model-par 2 --device cpu --comm gloo``

Engine configuration rides on one surface: ``--plan plan.json``, an
:class:`repro_torch.core.plan.EnginePlan` (write one with
``EnginePlan(...).save(path)``; the reference's plan files load as they
are).  The per-stage flags (``--mode``, ``--sim-mode``, ...) are
deprecated aliases that materialize a plan; combining them with
``--plan`` is an error.  The run is on the card unless ``--device cpu``
asks for the CPU; with no card the default raises.

The parser has every flag of the reference, with its default and
choices, plus ``--device`` and ``--comm``.  ``--resume-dir``,
``--fault-plan``, ``--on-overflow`` and ``--rebalance`` route the run
through the resilient stage runner (``repro_torch.run``), ``--stream``
replays the dataset through the windowed streaming service
(``repro_torch.serve.stream``); a classified failure exits with the
reference's code (``EXIT_CODES``: 3 overflow, 4 corruption, 5 retries
exhausted, 6 injected crash, 7 poison record, 8 backpressure).
``--distributed P --model-par M`` runs the multi-device program
(``core/distributed.py``) on a ``P x M`` mesh of spawned ranks, over the
transport ``--comm`` names (required with ``--distributed``: ``gloo`` on
the CPU or with ranks sharing a card, ``nccl`` with a card per rank).
With the resilient options it runs the multi-device resilient runner
(``run_resilient_distributed``, one spawn of the ranks for the whole
run); ``--elastic-resume`` resumes a checkpoint written at another
partition count, and without ``--resume-dir`` and ``--distributed`` it is
the reference's usage error.

The README's table of this parser is generated (``--print-cli-table``)
and checked (``--check-readme``) between its own markers.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs.registry import get_dsc_config
from repro_torch.core.dsc import cluster_summary, run_dsc
from repro_torch.core.plan import EnginePlan
from repro_torch.core.types import DSCParams
from repro_torch.data.synthetic import (ais_like, default_dsc_params_for,
                                        figure1_scenario)
from repro_torch.kernels import resolve_device
from repro_torch.run import EXIT_CODES
from repro_torch.utils.logging import get_logger

log = get_logger("run_dsc")

# README markers the generated CLI table of this parser lives between
CLI_TABLE_BEGIN = ("<!-- cli-table-torch:begin (generated by python -m "
                   "repro_torch.launch.run_dsc --print-cli-table) -->")
CLI_TABLE_END = "<!-- cli-table-torch:end -->"

def make_dataset(name: str, n_trajs: int, max_points: int, seed: int = 0,
                 device=None):
    """The launcher's data for config ``name`` on ``device`` (``None`` =
    the card): the figure-1 scenario for ``dsc_synth``, AIS-like vessels
    on 8 lanes otherwise."""
    if name == "dsc_synth":
        per = max(1, n_trajs // 6)
        return figure1_scenario(n_per_route=per, points_per_leg=32,
                                seed=seed, device=device)[0]
    return ais_like(n_vessels=n_trajs, max_points=max_points,
                    n_lanes=8, seed=seed, device=device)[0]


# legacy per-stage flags -> (EnginePlan.from_legacy keyword, plan field)
_LEGACY_FLAGS = {
    "use_kernel": "use_kernel",
    "use_index": "use_index",
    "mode": "mode",
    "cluster_engine": "cluster_engine",
    "cluster_use_kernel": "cluster_use_kernel",
    "seg_use_kernel": "seg_use_kernel",
    "sim_mode": "sim_mode",
    "sim_topk": "sim_topk",
    "halo_stream": "halo_stream",
    "sim_exchange": "sim_exchange",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.run_dsc",
        description="Run the DSC pipeline of the PyTorch/CUDA port on one "
                    "device.")
    ap.add_argument("--config", default="dsc_synth",
                    help="dataset/config name from the registry")
    ap.add_argument("--n-trajs", type=int, default=None,
                    help="trajectory count override (default: config, at "
                         "most 64)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the pipeline runs: the card (the kernels "
                         "of the plan; raises without a card) or the CPU "
                         "(the plain PyTorch versions)")
    ap.add_argument("--comm", default=None, choices=["nccl", "gloo"],
                    help="transport of the --distributed mesh (required "
                         "with it): gloo (the CPU, or ranks sharing one "
                         "card through host memory) or nccl (one card per "
                         "rank)")
    ap.add_argument("--distributed", type=int, default=0,
                    help="number of temporal partitions (0 = single host; "
                         "P>0 runs the multi-device program on P x "
                         "model-par spawned ranks)")
    ap.add_argument("--model-par", type=int, default=1,
                    help="model-axis width (candidate-column sharding)")
    ap.add_argument("--plan", default=None, metavar="PLAN.json",
                    help="EnginePlan JSON: the single surface owning every "
                         "per-stage engine choice; mutually exclusive with "
                         "the deprecated per-stage flags below")
    ap.add_argument("--use-kernel", action="store_true",
                    help="[deprecated alias: plan.use_kernel] CUDA join "
                         "kernel in materialize mode")
    ap.add_argument("--use-index", action="store_true",
                    help="[deprecated alias: plan.use_index] prune the "
                         "JOIN phase with the spatiotemporal grid index "
                         "(lossless)")
    ap.add_argument("--mode", default="materialize",
                    choices=["materialize", "fused"],
                    help="[deprecated alias: plan.mode] join execution "
                         "mode: materialize the [T, M, C] join cube or "
                         "stream it through the fused passes (no cube)")
    ap.add_argument("--cluster-engine", default="rounds",
                    choices=["rounds", "sequential"],
                    help="[deprecated alias: plan.cluster_engine] Problem "
                         "3 engine: round-parallel greedy or the O(S) "
                         "sequential oracle — label-identical outputs")
    ap.add_argument("--cluster-use-kernel", action="store_true",
                    help="[deprecated alias: plan.cluster_use_kernel] back "
                         "the round engine with the CUDA round-scan and "
                         "claim-max kernels")
    ap.add_argument("--seg-use-kernel", action="store_true",
                    help="[deprecated alias: plan.seg_use_kernel] compute "
                         "the TSA2 Jaccard signal with the CUDA kernel "
                         "(bit-identical cuts; no-op under tsa1)")
    ap.add_argument("--sim-mode", default="dense",
                    choices=["dense", "topk"],
                    help="[deprecated alias: plan.sim_mode] SP "
                         "representation: the dense [S, S] similarity "
                         "matrix or panel-streamed top-K neighbor lists "
                         "(labels equal whenever the overflow certificate "
                         "is zero; K widens until it is)")
    ap.add_argument("--sim-topk", type=int, default=None,
                    help="[deprecated alias: plan.sim_topk] K of the "
                         "top-K neighbor lists (default 32, clamped to "
                         "S); only with --sim-mode topk")
    ap.add_argument("--halo-stream", default="barrier",
                    choices=["barrier", "ring"],
                    help="[deprecated alias: plan.halo_stream] JOIN halo "
                         "schedule of the multi-device program (not read "
                         "on one device)")
    ap.add_argument("--sim-exchange", default="allgather",
                    choices=["allgather", "ring"],
                    help="[deprecated alias: plan.sim_exchange] similarity "
                         "exchange schedule of the multi-device program "
                         "(not read on one device)")
    ap.add_argument("--segmentation", default=None,
                    help="segmentation algorithm override (tsa1 or tsa2)")
    ap.add_argument("--seed", type=int, default=0,
                    help="dataset RNG seed")
    ap.add_argument("--resume-dir", default=None, metavar="DIR",
                    help="run through the resilient stage runner, "
                         "checkpointing each stage boundary under DIR and "
                         "resuming from the first incomplete stage on "
                         "restart (bit-identical to a straight-through "
                         "run); with --stream, the service's snapshots")
    ap.add_argument("--on-overflow", default=None,
                    choices=["raise", "widen", "degrade"],
                    help="top-K overflow policy: fail loudly, double K "
                         "and re-run from the similarity stage, or accept "
                         "the truncated lists and record the certificate "
                         "(default: widen; implies the resilient runner)")
    ap.add_argument("--on-corruption", default="fallback",
                    choices=["fallback", "fail"],
                    help="damaged-checkpoint policy for --resume-dir: "
                         "discard the bad step and restore the newest "
                         "intact one, or exit with the corruption code")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="bounded exponential-backoff retries per stage "
                         "before giving up (resilient runner)")
    ap.add_argument("--fault-plan", default=None, metavar="FAULTS.json",
                    help="FaultPlan JSON scripting deterministic failures "
                         "(crash/transient/corruption/slowdown, stream "
                         "chaos) — implies the resilient runner")
    ap.add_argument("--elastic-resume", action="store_true",
                    help="allow --resume-dir checkpoints written at a "
                         "different partition count: join/segment state "
                         "folds to global point space and re-cuts for "
                         "this mesh, later stages rewind to the segment "
                         "boundary — bit-identical to a straight-through "
                         "run at the new P (distributed only; DESIGN.md "
                         "section 11)")
    ap.add_argument("--rebalance", default=None,
                    choices=["off", "suggest", "apply"],
                    help="straggler-flag policy (RebalancePolicy): "
                         "ignore flags, emit slowdown-weighted "
                         "rebalance-edge suggestions to telemetry "
                         "(default), or apply the re-cut at the next "
                         "join/segment boundary and checkpoint the "
                         "repartitioned state (multi-device: one device "
                         "has no re-cut); implies the resilient runner")
    ap.add_argument("--sync-saves", action="store_true",
                    help="write stage checkpoints synchronously instead "
                         "of overlapping the save with the next stage "
                         "(results are identical either way)")
    ap.add_argument("--stream", action="store_true",
                    help="run the windowed streaming service instead of a "
                         "batch pipeline: the dataset is replayed as "
                         "point-record submissions through ingest "
                         "validation, the bounded-lateness watermark and "
                         "incremental window advances (standing state on "
                         "the device; --resume-dir snapshots and resumes "
                         "it, --fault-plan scripts stream chaos)")
    ap.add_argument("--stream-batch-size", type=int, default=64,
                    help="records per submission batch (--stream)")
    ap.add_argument("--stream-order", default="time",
                    choices=["time", "traj"],
                    help="record replay order (--stream)")
    ap.add_argument("--pump-every", type=int, default=1,
                    help="window advances once per this many submissions "
                         "(--stream)")
    ap.add_argument("--allowed-lateness", type=float, default=None,
                    help="bounded-lateness watermark slack in event-time "
                         "seconds (--stream)")
    ap.add_argument("--horizon", type=float, default=None,
                    help="active-window retention in event-time seconds "
                         "(--stream)")
    ap.add_argument("--queue-cap", type=int, default=4096,
                    help="staging-queue record capacity (--stream)")
    ap.add_argument("--backpressure", default="shed_oldest",
                    choices=["shed_oldest", "block"],
                    help="staging-queue overflow policy (--stream)")
    ap.add_argument("--on-dirty", default="repair",
                    choices=["repair", "drop", "fail"],
                    help="dirty-record policy (--stream)")
    ap.add_argument("--max-speed", type=float, default=None,
                    help="GPS-teleport gate in units/second (--stream)")
    ap.add_argument("--snapshot-every", type=int, default=1,
                    help="full-state snapshot cadence in window advances "
                         "(--stream)")
    ap.add_argument("--stream-k", type=int, default=8,
                    help="standing neighbor-list width K (--stream)")
    ap.add_argument("--alpha-abs", type=float, default=0.1,
                    help="absolute similarity threshold (--stream)")
    ap.add_argument("--k-abs", type=float, default=0.0,
                    help="absolute voting threshold (--stream)")
    ap.add_argument("--print-cli-table", action="store_true",
                    help="print the generated markdown CLI reference "
                         "table (the one embedded in the README) and exit")
    ap.add_argument("--check-readme", default=None, nargs="?",
                    const="README.md", metavar="README",
                    help="verify the README's embedded CLI table of this "
                         "launcher matches this parser and exit nonzero on "
                         "drift")
    return ap


def cli_reference_table() -> str:
    """Markdown CLI reference generated from :func:`build_parser`, one row
    per flag (the reference's generator)."""
    ap = build_parser()
    lines = ["| flag | default | description |",
             "| --- | --- | --- |"]
    for a in ap._actions:
        if "--help" in a.option_strings or not a.option_strings:
            continue
        flag = " ".join(f"`{s}`" for s in a.option_strings)
        if a.metavar:
            flag += f" `{a.metavar}`"
        elif a.choices:
            flag += " `{" + ",".join(map(str, a.choices)) + "}`"
        elif a.type is int:
            flag += " `N`"
        elif not isinstance(a, (argparse._StoreTrueAction,
                                argparse._StoreConstAction)):
            flag += " `V`"
        if isinstance(a, argparse._StoreTrueAction):
            default = "off"
        elif a.default is None:
            default = "—"
        else:
            default = f"`{a.default}`"
        help_ = " ".join((a.help or "").split())
        lines.append(f"| {flag} | {default} | {help_} |")
    return "\n".join(lines) + "\n"


def readme_cli_table(readme_path: str) -> str:
    """The embedded CLI table of this launcher (between its markers)."""
    with open(readme_path) as f:
        text = f.read()
    try:
        _, rest = text.split(CLI_TABLE_BEGIN, 1)
        body, _ = rest.split(CLI_TABLE_END, 1)
    except ValueError:
        raise ValueError(
            f"{readme_path} is missing the CLI-table markers "
            f"{CLI_TABLE_BEGIN!r} / {CLI_TABLE_END!r}") from None
    return body.strip("\n") + "\n"


def check_readme_cli_table(readme_path: str) -> list[str]:
    """Diff lines between the README's table and the generated one
    (empty list = in sync)."""
    import difflib
    want = cli_reference_table().splitlines()
    have = readme_cli_table(readme_path).splitlines()
    return list(difflib.unified_diff(have, want, fromfile=readme_path,
                                     tofile="--print-cli-table", lineterm=""))


def plan_from_args(args, parser: argparse.ArgumentParser) -> EnginePlan:
    """One plan from the CLI: ``--plan`` JSON, or the deprecated aliases;
    mixing both is a parser error."""
    legacy = {kw: getattr(args, attr)
              for attr, kw in _LEGACY_FLAGS.items()}
    if args.plan is None:
        return EnginePlan.from_legacy(**legacy)
    defaults = {a.dest: a.default for a in parser._actions}
    stray = [f"--{attr.replace('_', '-')}" for attr in _LEGACY_FLAGS
             if getattr(args, attr) != defaults[attr]]
    if stray:
        parser.error(f"--plan cannot be combined with the deprecated "
                     f"per-stage flags ({', '.join(stray)}); set those "
                     "fields in the plan JSON instead")
    return EnginePlan.load(args.plan)


def _resilient(args) -> bool:
    """Whether the options route the run through the resilient runner."""
    return (args.resume_dir is not None or args.fault_plan is not None
            or args.on_overflow is not None or args.rebalance is not None)


def _refuse(args, parser: argparse.ArgumentParser) -> None:
    """Exit through the parser, before any data is made, on options that
    cannot go together (the reference's own errors) or a mesh without its
    transport."""
    if args.stream:
        if args.distributed:
            parser.error("--stream is a single-host service "
                         "(no --distributed)")
        return
    if args.elastic_resume and not (_resilient(args) and args.distributed):
        parser.error("--elastic-resume needs --resume-dir and --distributed "
                     "(elastic adaptation is a distributed-checkpoint "
                     "feature)")
    if args.distributed and args.comm is None:
        parser.error("--distributed needs --comm {nccl,gloo}: the mesh's "
                     "transport is never chosen silently")


def _exit_code_for(exc) -> int | None:
    """Map a failure to its documented process exit code (None = not a
    classified failure; let it propagate as a plain error)."""
    from repro_torch.run import (CheckpointCorruption, InjectedCrash,
                                 OverflowViolation, RetriesExhausted)
    from repro_torch.stream import (BackpressureOverflow, PoisonRecord,
                                    WatermarkStall)
    if isinstance(exc, InjectedCrash):
        return EXIT_CODES["injected_crash"]
    if isinstance(exc, RetriesExhausted):
        return EXIT_CODES["retries_exhausted"]
    if isinstance(exc, CheckpointCorruption):
        return EXIT_CODES["corruption"]
    if isinstance(exc, OverflowViolation):
        return EXIT_CODES["overflow"]
    if isinstance(exc, RuntimeError) and "sim_topk" in str(exc):
        return EXIT_CODES["overflow"]  # run_dsc's raise path
    if isinstance(exc, PoisonRecord):
        return EXIT_CODES["poison"]
    if isinstance(exc, (BackpressureOverflow, WatermarkStall)):
        return EXIT_CODES["backpressure"]
    return None


def _classified(fn, *a):
    """``fn(*a)``, a classified failure turned into its exit code."""
    try:
        return fn(*a)
    except Exception as e:  # noqa: BLE001 - classified failure -> exit code
        code = _exit_code_for(e)
        if code is None:
            raise
        log.error("%s: %s (exit code %d)", type(e).__name__, e, code)
        raise SystemExit(code) from e


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.print_cli_table:
        print(cli_reference_table(), end="")
        return None
    if args.check_readme is not None:
        diff = check_readme_cli_table(args.check_readme)
        if diff:
            raise SystemExit(
                "README CLI table is out of sync with the parser — "
                "regenerate it with --print-cli-table:\n" + "\n".join(diff))
        print(f"{args.check_readme}: CLI table in sync")
        return None
    plan = plan_from_args(args, ap)
    _refuse(args, ap)
    dev = resolve_device(args.device)

    rc = get_dsc_config(args.config)
    n_trajs = args.n_trajs or min(rc.n_trajs, 64)
    batch = make_dataset(args.config, n_trajs, rc.max_points, args.seed,
                         device=dev)
    diam, mean_dt = default_dsc_params_for(batch)
    params = DSCParams(
        eps_sp=0.15 * diam if args.config != "dsc_synth" else 0.42,
        eps_t=1.0 * mean_dt, delta_t=rc.delta_t,
        w=min(rc.w, 6 if args.config == "dsc_synth" else rc.w),
        tau=0.15 if args.config == "dsc_synth" else rc.tau,
        alpha_sigma=-1.0, k_sigma=-1.0,
        max_subtrajs_per_traj=rc.max_subtrajs,
        segmentation=args.segmentation or ("tsa2" if args.config ==
                                           "dsc_synth" else rc.segmentation))

    if args.stream:
        return _classified(_run_stream, args, batch, mean_dt, dev)
    if args.distributed:
        return _classified(_run_distributed, args, batch, params, plan, dev,
                           _resilient(args))
    return _classified(_run_batch, args, batch, params, plan, dev,
                       _resilient(args))


def _run_distributed(args, batch, params, plan, dev, resilient: bool):
    """The multi-device program (through the resilient runner when asked)
    on a ``--distributed x --model-par`` mesh of spawned ranks on
    ``dev``'s kind of device, logged as the reference logs it."""
    import numpy as np

    from repro_torch.core.distributed import run_dsc_distributed
    from repro_torch.core.partitioning import partition_batch
    from repro_torch.distributed.mesh import Mesh
    P = args.distributed
    t0 = time.time()
    mesh = Mesh((P, args.model_par), args.comm, device=dev.type)
    parts = partition_batch(batch, P)
    # the program has no in-graph K widening: keep the default of 32
    # explicit in the plan, as the reference does
    if plan.sim_mode == "topk" and plan.sim_topk is None:
        plan = plan.replace(sim_topk=32)
    if resilient:
        out = _run_resilient(args, parts, params, plan, dev, mesh=mesh)
    else:
        out = run_dsc_distributed(parts, params, mesh, plan=plan)
    res = out.result
    n_rep = int(res.is_rep.sum())
    n_out = int(res.is_outlier.sum())
    n_mem = int(np.sum((res.member_of.cpu().numpy() >= 0)
                       & ~res.is_rep.cpu().numpy()))
    log.info("distributed DSC (%d partitions x %d model): "
             "%d clusters, %d members, %d outliers in %.2fs",
             P, args.model_par, n_rep, n_mem, n_out, time.time() - t0)
    return out


def _run_batch(args, batch, params, plan, dev, resilient: bool):
    """One DSC run (through the resilient runner when asked), logged as
    the reference logs it."""
    t0 = time.time()
    if resilient:
        out = _run_resilient(args, batch, params, plan, dev)
    else:
        out = run_dsc(batch, params, plan=plan, device=dev)
    s = cluster_summary(out)
    log.info("DSC: %d clusters, %d outliers, RMSE %.4f, SSCR "
             "%.2f in %.2fs", s["num_clusters"], len(s["outliers"]),
             s["rmse"], s["sscr"], time.time() - t0)
    for rep, members in sorted(s["clusters"].items(),
                               key=lambda kv: -len(kv[1]))[:8]:
        log.info("  cluster rep=%d size=%d", rep, len(members))
    return out


def _run_stream(args, batch, mean_dt, dev):
    """Replay the dataset as a record stream through the windowed
    incremental service (DESIGN.md §13), its state on ``dev``; the
    reference's configuration (``eps_sp`` 0.42 on dsc_synth, else 0.3)."""
    from pathlib import Path

    from repro_torch.data.synthetic import stream_records
    from repro_torch.run import FaultInjector, FaultPlan, Telemetry
    from repro_torch.serve.stream import StreamService
    from repro_torch.stream import StreamConfig

    t = batch.t.cpu().numpy()[batch.valid.cpu().numpy()]
    span = float(t.max() - t.min()) if t.size else 1.0
    lateness = (args.allowed_lateness if args.allowed_lateness is not None
                else 2.0 * mean_dt)
    horizon = (args.horizon if args.horizon is not None
               else max(span, lateness))
    cfg = StreamConfig(
        t_cap=batch.num_trajs, m_cap=batch.max_points,
        eps_sp=0.42 if args.config == "dsc_synth" else 0.3,
        eps_t=1.0 * mean_dt, alpha_abs=args.alpha_abs, k_abs=args.k_abs,
        allowed_lateness=lateness, horizon=horizon,
        k=args.stream_k, w=min(6, batch.max_points // 2),
        queue_cap=args.queue_cap, backpressure=args.backpressure,
        on_dirty=args.on_dirty, max_speed=args.max_speed,
        snapshot_every=args.snapshot_every if args.resume_dir else 0)
    fault_plan = (FaultPlan.load(args.fault_plan)
                  if args.fault_plan else None)
    injector = FaultInjector(fault_plan) if fault_plan else None
    telemetry = None
    if args.resume_dir:
        Path(args.resume_dir).mkdir(parents=True, exist_ok=True)
        telemetry = Telemetry(Path(args.resume_dir) / "telemetry.jsonl",
                              time.time)
    svc = StreamService(cfg, checkpoint_dir=args.resume_dir,
                        telemetry=telemetry, injector=injector, device=dev)
    if svc.resumed:
        log.info("resumed stream service at advance %d (cursor %d)",
                 svc.driver.advance_count, svc.driver.cursor)
    batches = stream_records(batch, batch_size=args.stream_batch_size,
                             order=args.stream_order)
    t0 = time.time()
    stats = svc.run(batches, pump_every=args.pump_every)
    acc = svc.accounting()
    log.info("stream: %d advances, %d objects, %d points in window, "
             "%d reps, %d outliers in %.2fs", stats["advances"],
             stats["objects"], stats["points"], stats["reps"],
             stats["outliers"], time.time() - t0)
    log.info("accounting: submitted=%d inserted=%d quarantined=%d "
             "late=%d shed=%d balanced=%s", acc["submitted"],
             acc["inserted"], acc["quarantined"], acc["late_dropped"],
             acc["shed_queue"] + acc["shed_capacity"], acc["balanced"])
    if not acc["balanced"]:
        raise RuntimeError(f"stream accounting imbalance: {acc}")
    return stats


def _run_resilient(args, data, params, plan, dev, mesh=None):
    """Route a launcher invocation through the resilient stage runner:
    one device, or the mesh's (``data`` is then the partitioned batch)."""
    from repro_torch.run import (FaultPlan, RebalancePolicy, run_resilient,
                                 run_resilient_distributed)
    fault_plan = (FaultPlan.load(args.fault_plan)
                  if args.fault_plan else None)
    rebalance = (RebalancePolicy(mode=args.rebalance)
                 if args.rebalance is not None else None)
    kw = dict(plan=plan, checkpoint_dir=args.resume_dir,
              on_overflow=args.on_overflow or "widen",
              on_corruption=args.on_corruption,
              fault_plan=fault_plan, max_retries=args.max_retries,
              rebalance=rebalance, sync_saves=args.sync_saves)
    if mesh is None:
        res = run_resilient(data, params, device=dev, **kw)
    else:
        res = run_resilient_distributed(data, params, mesh,
                                        elastic_resume=args.elastic_resume,
                                        **kw)
    log.info("resilient run: resumed_from=%s widen_count=%d "
             "rebalance_count=%d fallback_steps=%s", res.resumed_from,
             res.widen_count, res.rebalance_count, res.fallback_steps)
    return res.output


if __name__ == "__main__":
    main()
