"""Plan autotuner: sweep EnginePlan choices, verify, cache winners.

The port's counterpart of ``repro.tune.autotune``, with its names, its
candidate lists, its ranking and its store format:

* **Measure each candidate on the device.**  ``measure_call`` runs the
  candidate once untimed (on the card that first call also builds the
  kernels), then ``iters`` times between two ``torch.cuda.synchronize()``
  calls, and keeps the minimum wall.  It takes the place of the
  reference's ``measure_compiled``: PyTorch has no compile step to split
  off and no HLO to read.
* **Verify before accept.**  A candidate is eligible only if its output
  is bit-identical to the stage's oracle: the labels of the materialize
  run for the join sweep, the plain round engine's six result fields for
  the cluster sweep, the dense lists and moments for the panel sweep,
  the barrier schedule's labels for the comm sweep.
* **Deterministic winner.**  Verified candidates are ranked by
  ``(peak_interface_bytes, wall_s, index)``, as in the reference.  The
  interface bytes are the largest tensor among the call's arguments and
  its result (``interface_bytes``), the tensor-level counterpart of the
  reference's ``interface_buffer_stats`` over the ENTRY computation's
  parameters and root.  Candidate 0 is the base plan, so a tuned plan
  never has more interface bytes than the untuned one.
* **Cached per (shape bucket, backend, torch version).**  Keys are
  ``stage|bucket|backend|torchVERSION``, with ``backend`` ``"gpu"`` or
  ``"cpu"`` from the tuner's device.  The JSON layout is the reference's,
  so either package loads the other's store file and keeps its records;
  ``get`` finds only its own package's keys.

On the card no kernel reads the TPU tile fields (``fused_rows``,
``fused_bc``, ``fused_bm``, ``cluster_bu``, ``cluster_bs``): the fused
rows of ``join_candidates`` run one computation, and so do the kernel
rows of ``cluster_candidates``.  They are measured and verified all the
same; their spread is the wall's noise, and a stored winner's tile fields
carry no meaning there.  ``sim_panel`` (the top-K panel height) and the
comm schedules are read.

``peak_buffer_bytes`` holds the card's allocation peak over the timed
calls above what was allocated before them
(``torch.cuda.max_memory_allocated``), not the reference's largest HLO
buffer; it is ``None`` on the CPU, where torch keeps no allocation peak.
``roofline`` is ``None``: there is no HLO to place on a roofline.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time

import torch

from repro_torch.core.clustering import cluster_rounds
from repro_torch.core.distributed import build_dsc_program
from repro_torch.core.dsc import run_dsc_lowerable
from repro_torch.core.plan import EnginePlan
from repro_torch.core.similarity import (_ordered_add, contribution_panel_raw,
                                         finalize_sim, plan_panel,
                                         sim_row_moments, topk_reduce_rows,
                                         topk_stream)
from repro_torch.distributed import mesh as mesh_mod
from repro_torch.kernels import resolve_device

_LABEL_FIELDS = ("member_of", "is_rep", "is_outlier")
_CLUSTER_FIELDS = ("member_of", "member_sim", "is_rep", "is_outlier",
                   "alpha_used", "k_used")
_TOPK_FIELDS = ("ids", "sims", "spill", "degree", "row_sum", "row_sumsq")


# --------------------------------------------------------------------------
# cache keys and the plan store
# --------------------------------------------------------------------------

def shape_bucket(**dims) -> str:
    """Deterministic shape-bucket string: each dim rounded up to a power
    of two (``T=24 -> T32``), keys sorted.  A sweep tuned at the bucket
    ceiling serves every shape in the bucket — tile validity and relative
    ranking are stable within a 2x band, and exact-shape keys would make
    the cache miss on every workload."""
    parts = []
    for k in sorted(dims):
        v = int(dims[k])
        parts.append(f"{k}{1 if v <= 1 else 2 ** math.ceil(math.log2(v))}")
    return "-".join(parts)


def _backend(device=None) -> str:
    """``"gpu"`` or ``"cpu"``: the backend of a tuner's device (``None``
    means the card, which must exist)."""
    return "gpu" if resolve_device(device).type == "cuda" else "cpu"


def plan_cache_key(stage: str, bucket: str, backend: str | None = None,
                   torch_version: str | None = None) -> str:
    """``stage|bucket|backend|torchVERSION`` — the PlanStore key
    (``backend=None`` is the card's, ``"gpu"``)."""
    backend = backend or _backend()
    torch_version = torch_version or torch.__version__
    return f"{stage}|{bucket}|{backend}|torch{torch_version}"


class PlanStore:
    """JSON store of tuned plans: cache key -> winner record.

    ``get`` returns the cached :class:`EnginePlan` (or None);
    ``put`` records a :class:`TuneResult`'s winner, under the backend the
    result was measured on unless ``backend=`` says otherwise; ``save``
    writes the whole store (winner plan + per-candidate audit trail) to
    ``path``.  Records of the reference's keys (``...|jaxVERSION``) load
    and save unchanged.
    """

    def __init__(self, path: str | None = None):
        self.path = path
        self.records: dict[str, dict] = {}
        if path is not None and os.path.exists(path):
            with open(path) as f:
                self.records = json.load(f)

    def get(self, stage: str, bucket: str, **key_kw) -> EnginePlan | None:
        rec = self.records.get(plan_cache_key(stage, bucket, **key_kw))
        return None if rec is None else EnginePlan.from_dict(rec["plan"])

    def put(self, result: "TuneResult", **key_kw) -> str:
        key_kw.setdefault("backend", result.backend)
        key = plan_cache_key(result.stage, result.bucket, **key_kw)
        self.records[key] = result.to_dict()
        return key

    def save(self, path: str | None = None) -> str:
        path = path or self.path
        if path is None:
            raise ValueError("PlanStore has no path")
        with open(path, "w") as f:
            json.dump(self.records, f, indent=2, sort_keys=True)
            f.write("\n")
        return path


# --------------------------------------------------------------------------
# measurement
# --------------------------------------------------------------------------

def interface_bytes(obj) -> int:
    """``nbytes`` of the largest tensor in ``obj`` (dataclasses, tuples,
    lists and dicts are walked; 0 without a tensor)."""
    if torch.is_tensor(obj):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return max((interface_bytes(v) for v in obj), default=0)
    return 0


def measure_call(fn, args, iters: int = 1, *, device=None):
    """``(out, wall_s, buffers)`` of ``fn(*args)`` on ``device`` (``None``
    = the card, which must exist).

    One untimed warm call (on the card it also builds the kernels at
    first use), then ``iters`` timed calls; ``wall_s`` is the minimum of
    their host-clock walls, each between two device synchronizations
    (minimum, not median: noise is one-sided).  ``buffers`` holds
    ``interface_bytes`` (the largest tensor among ``args`` and the result)
    and ``peak_bytes``: the card's allocation peak over the timed calls
    above what was allocated before them, ``None`` on the CPU.
    """
    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    out = fn(*args)
    sync()
    out = None
    if cuda:
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    wall = math.inf
    for _ in range(max(iters, 1)):
        out = None
        sync()
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        wall = min(wall, time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) - base if cuda else None
    return out, wall, {"interface_bytes": interface_bytes((args, out)),
                       "peak_bytes": peak}


def _roofline(buffers: dict) -> dict | None:
    """None: the reference places a compiled HLO on its roofline
    (``benchmarks.roofline``, and None where that is not importable);
    PyTorch gives no HLO."""
    return None


# --------------------------------------------------------------------------
# the sweep
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CandidateRecord:
    plan: EnginePlan
    wall_s: float
    verified: bool
    peak_interface_bytes: int
    peak_buffer_bytes: int | None
    roofline: dict | None
    note: str = ""

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["plan"] = self.plan.to_dict()
        d["wall_s"] = None if math.isinf(self.wall_s) else self.wall_s
        return d


@dataclasses.dataclass
class TuneResult:
    stage: str
    bucket: str
    candidates: list[CandidateRecord]
    default: CandidateRecord        # candidates[0] — the untuned baseline
    winner: CandidateRecord
    backend: str                    # "gpu" | "cpu": where it was measured

    def to_dict(self) -> dict:
        return {
            "stage": self.stage, "bucket": self.bucket,
            "backend": self.backend, "torch": torch.__version__,
            "plan": self.winner.plan.to_dict(),
            "winner": self.winner.to_dict(),
            "default": self.default.to_dict(),
            "candidates": [c.to_dict() for c in self.candidates],
        }


def sweep(stage: str, bucket: str, candidates, measure, verify,
          store: PlanStore | None = None, **store_kw) -> TuneResult:
    """Measure every candidate plan once, verify, pick the winner.

    ``measure(plan) -> (out, wall_s, buffers)`` is the measurement (as
    ``measure_call`` returns it); ``verify(out, plan) -> bool`` is the
    bit-identity check against the stage oracle.  Both are injectable so
    tests can pin a fixed candidate set (determinism) or plant a
    deliberately-wrong candidate (rejection).  Candidate 0 must be the
    stage's default plan; a candidate whose measurement *raises* (invalid
    geometry) is recorded as unverified rather than aborting the sweep.
    Winner = the verified candidate minimizing ``(peak_interface_bytes,
    wall_s, index)`` — fully deterministic given the measurements.
    ``store_kw`` (``backend=``, ``torch_version=``) keys the store; the
    result records ``backend`` (default: the card's, ``"gpu"``).
    """
    backend = store_kw.get("backend") or _backend()
    records: list[CandidateRecord] = []
    for plan in candidates:
        try:
            out, wall, buffers = measure(plan)
        except Exception as e:  # noqa: BLE001 — geometry rejected, not fatal
            records.append(CandidateRecord(
                plan=plan, wall_s=math.inf, verified=False,
                peak_interface_bytes=-1, peak_buffer_bytes=-1,
                roofline=None, note=f"measure failed: {e}"))
            continue
        ok = bool(verify(out, plan))
        del out
        records.append(CandidateRecord(
            plan=plan, wall_s=wall, verified=ok,
            peak_interface_bytes=buffers["interface_bytes"],
            peak_buffer_bytes=buffers["peak_bytes"],
            roofline=_roofline(buffers),
            note="" if ok else "rejected: not bit-identical to the oracle"))
    eligible = [(r.peak_interface_bytes, r.wall_s, i)
                for i, r in enumerate(records) if r.verified]
    if not eligible:
        raise RuntimeError(
            f"tune[{stage}]: no candidate survived verification "
            f"({[r.note for r in records]})")
    winner = records[min(eligible)[2]]
    result = TuneResult(stage=stage, bucket=bucket, candidates=records,
                        default=records[0], winner=winner, backend=backend)
    if store is not None:
        store.put(result, **store_kw)
    return result


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shape, dtype and bits (``b`` moved to ``a``'s device)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a, b.to(a.device)))


def _labels_equal(res_a, res_b) -> bool:
    return all(_same_bits(getattr(res_a, f), getattr(res_b, f))
               for f in _LABEL_FIELDS)


# --------------------------------------------------------------------------
# the stage sweeps
# --------------------------------------------------------------------------

def join_candidates(T: int, M: int, base: EnginePlan) -> list[EnginePlan]:
    """Join-stage candidate lattice for a ``[T, M]`` self-join.

    Candidate 0 is ``base`` untouched (on the default plan that is the
    materializing oracle, so the sweep measures the cube path and the
    fused path side by side).  The rest are fused plans on the
    reference's ``(rows, bc, bm)`` lattice around the fat-tile default;
    duplicates are dropped by their pre-clamp key only.  No CUDA kernel
    reads the tile fields: the fused rows are one computation.
    """
    cands = [base]
    seen = set()

    def add(rows, bc, bm):
        rows = None if rows is None else max(1, min(int(rows), T))
        bm = max(8, min(int(bm), M))
        key = (rows, bc, bm)
        if key in seen:
            return
        seen.add(key)
        cands.append(base.replace(mode="fused", fused_rows=rows,
                                  fused_bc=bc, fused_bm=bm))

    add(None, 16, 128)                       # the fused library default
    auto_rows = max(1, 2048 // max(M, 1))
    for rows in (1, 4, auto_rows):
        for bc, bm in ((8, 64), (16, 128), (32, 32)):
            if len(cands) >= 8:
                return cands
            add(rows, bc, bm)
    return cands


def _on(batch, dev):
    return batch if batch.device == dev else batch.to(dev)


def tune_join(batch, params, base: EnginePlan | None = None,
              candidates: list[EnginePlan] | None = None,
              store: PlanStore | None = None, iters: int = 1,
              oracle=None, *, device=None) -> TuneResult:
    """Tune the join mode (and the reference's fused tile lattice) by
    running the whole pipeline, ``run_dsc_lowerable``, on ``device``
    (``None`` = the card).

    Verification is final-label bit-identity against the materializing
    oracle, ``base.replace(mode="materialize")`` (``oracle``: its
    ``DSCOutput``, when the caller already has it).  The interface-bytes
    key reflects whether the ``[T, M, C]`` cube leaves the call.
    """
    dev = resolve_device(device)
    batch = _on(batch, dev)
    T, M = batch.x.shape
    base = (base or EnginePlan()).validate()
    if candidates is None:
        candidates = join_candidates(T, M, base)

    def measure(plan):
        return measure_call(
            lambda b: run_dsc_lowerable(b, params, plan, device=dev),
            (batch,), iters=iters, device=dev)

    if oracle is None:
        oracle = run_dsc_lowerable(batch, params,
                                   base.replace(mode="materialize"),
                                   device=dev)
    want = oracle.result
    del oracle                          # the cube need not stay alive

    def verify(out, plan):
        return _labels_equal(out.result, want)

    return sweep("join", shape_bucket(T=T, M=M), candidates,
                 measure, verify, store=store, backend=_backend(dev))


def cluster_candidates(S: int, base: EnginePlan) -> list[EnginePlan]:
    """Cluster-stage candidates: the base engine untouched (candidate 0 —
    plain unless the base plan already picked the kernels), then the
    round kernels over the reference's (bu, bs) lattice (one computation
    on the card: no kernel reads the tile fields)."""
    cands = [base]
    for bu, bs in ((8, 128), (8, 64), (16, 128), (8, 256), (16, 64)):
        plan = base.replace(cluster_engine="rounds",
                            cluster_use_kernel=True,
                            cluster_bu=bu, cluster_bs=bs)
        if plan not in cands:
            cands.append(plan)
    return cands


def tune_cluster_tiles(sim, table, params, base: EnginePlan | None = None,
                       candidates: list[EnginePlan] | None = None,
                       store: PlanStore | None = None, iters: int = 1,
                       *, device=None) -> TuneResult:
    """Tune the Problem 3 engine on a dense instance on ``device``.

    Oracle: the plain round engine.  The kernels are bit-identical to it,
    so verification compares all six result fields, not just labels.
    """
    dev = resolve_device(device)
    sim, table = mesh_mod.to_device((sim, table), dev)
    S = int(table.num_slots)
    base = (base or EnginePlan()).validate()
    if candidates is None:
        candidates = cluster_candidates(S, base)
    oracle_res = cluster_rounds(sim, table, params)

    def measure(plan):
        return measure_call(
            lambda s, t: cluster_rounds(s, t, params,
                                        use_kernel=plan.cluster_use_kernel,
                                        tiles=plan.cluster_tiles),
            (sim, table), iters=iters, device=dev)

    def verify(out, plan):
        return all(_same_bits(getattr(out, f), getattr(oracle_res, f))
                   for f in _CLUSTER_FIELDS)

    return sweep("cluster", shape_bucket(S=S), candidates,
                 measure, verify, store=store, backend=_backend(dev))


def panel_candidates(S: int, base: EnginePlan) -> list[EnginePlan]:
    """Similarity-stage candidates: the base panel (candidate 0), then a
    small Sb ladder.  ``plan_panel`` snaps each target to the largest
    divisor of S, so targets that collapse to the same Sb dedupe here."""
    cands, seen = [], set()
    for target in (base.sim_panel, 32, 64, 128, 256):
        Sb = plan_panel(S, target)
        if Sb in seen:
            continue
        seen.add(Sb)
        cands.append(base.replace(sim_mode="topk", sim_panel=Sb))
    return cands


def _dense_raw(src, dst, w, S: int) -> torch.Tensor:
    """The raw ``[S+1, S+1]`` scatter of a contribution list, each cell
    adding its entries in list order (as the reference's ``.at[src,
    dst].add``): ``_ordered_add``, since the card's
    ``index_put_(accumulate=True)`` reorders repeated indices."""
    raw = torch.zeros((S + 1) * (S + 1), dtype=torch.float32,
                      device=w.device)
    _ordered_add(raw, src.long() * (S + 1) + dst.long(), w)
    return raw.view(S + 1, S + 1)


def tune_sim_panel(src, dst, w, table, params,
                   base: EnginePlan | None = None,
                   candidates: list[EnginePlan] | None = None,
                   store: PlanStore | None = None,
                   iters: int = 1, *, device=None) -> TuneResult:
    """Tune the top-K panel height Sb on a contribution-list instance on
    ``device``.

    Oracle: the dense path — scatter (``_dense_raw``), ``finalize_sim``,
    then one ``topk_reduce_rows`` over full rows.  The streamed panel
    sweep is bitwise-equal to it for every divisor Sb, so verification
    compares ids, sims, the spill certificate and the threshold moments
    bit for bit; a panel height that breaks that is rejected.
    """
    dev = resolve_device(device)
    src, dst, w, table = mesh_mod.to_device((src, dst, w, table), dev)
    S = int(table.num_slots)
    base = (base or EnginePlan()).replace(sim_mode="topk")
    K = min(base.sim_topk if base.sim_topk is not None else 32, S)
    base = base.replace(sim_topk=K)
    if candidates is None:
        candidates = panel_candidates(S, base)
    sim = finalize_sim(_dense_raw(src, dst, w, S)[:S, :S], table)
    want = (*topk_reduce_rows(sim, K),
            *sim_row_moments(sim, table.valid, table.valid))
    del sim

    def measure(plan):
        def fn(src, dst, w):
            return topk_stream(
                contribution_panel_raw(src, dst, w, S, plan.sim_panel),
                table, k=K, panel=plan.sim_panel,
                use_kernel=plan.cluster_use_kernel)
        return measure_call(fn, (src, dst, w), iters=iters, device=dev)

    def verify(topk, plan):
        return all(_same_bits(getattr(topk, f), o)
                   for f, o in zip(_TOPK_FIELDS, want))

    return sweep("similarity", shape_bucket(S=S, K=K), candidates,
                 measure, verify, store=store, backend=_backend(dev))


def comm_candidates(base: EnginePlan) -> list[EnginePlan]:
    """Comm-schedule candidates (DESIGN.md §12): candidate 0 is the
    barrier baseline — the tuner's no-regression anchor — then each ring
    schedule alone, then both.  Ring and barrier schedules are
    bit-identical by construction, so a verification failure here is a
    real bug, not a rejected candidate."""
    barrier = base.replace(halo_stream="barrier", sim_exchange="allgather")
    cands = [barrier]
    for hs, se in (("ring", "allgather"), ("barrier", "ring"),
                   ("ring", "ring")):
        p = barrier.replace(halo_stream=hs, sim_exchange=se)
        if p not in cands:
            cands.append(p)
    return cands


def _tune_comm_rank(parts, params, mesh, part_axis, model_axis, base,
                    candidates, iters):
    return tune_comm(parts, params, mesh, part_axis=part_axis,
                     model_axis=model_axis, base=base,
                     candidates=candidates, iters=iters)


def tune_comm(parts, params, mesh, *, part_axis: str = "part",
              model_axis: str = "model", base: EnginePlan | None = None,
              candidates: list[EnginePlan] | None = None,
              store: PlanStore | None = None, iters: int = 1) -> TuneResult:
    """Tune the distributed communication schedules on a live mesh.

    On a rank of ``mesh`` each candidate runs ``build_dsc_program``'s
    body, timed by ``measure_call`` on the rank's device; each rank times
    its own program, so the ranked wall is the max over the mesh (one
    float64 through both axes) and every rank picks the same winner.
    Anywhere else this spawns the ``P * M`` ranks (``mesh.spawn``, as
    ``run_dsc_distributed`` does), checks that they named the same
    winner, and returns rank 0's result.  Verification is final-label
    bit-identity against candidate 0, the barrier baseline.  The
    interface-bytes key ties across schedules; the wall breaks the tie.
    """
    comm = mesh_mod.comm_for(mesh)
    if comm is None:
        results = mesh_mod.spawn(_tune_comm_rank, mesh, parts, params, mesh,
                                 part_axis, model_axis, base, candidates,
                                 iters)
        plans = [r.winner.plan for r in results]
        if any(p != plans[0] for p in plans):
            raise RuntimeError(f"tune[comm]: the ranks named different "
                               f"winners ({plans})")
        if store is not None:
            store.put(results[0])
        return results[0]
    dev = comm.device
    base = (base or EnginePlan()).validate()
    if candidates is None:
        candidates = comm_candidates(base)
    args = (parts.x, parts.y, parts.t, parts.valid, parts.traj_id,
            parts.ranges)

    def agreed(wall: float) -> float:
        x = torch.tensor([wall], dtype=torch.float64, device=dev)
        x = comm.all_gather(x, part_axis)
        return float(comm.all_gather(x, model_axis).max())

    def measure(plan):
        prog = build_dsc_program(parts, params, mesh, part_axis=part_axis,
                                 model_axis=model_axis, plan=plan)
        out, wall, buffers = measure_call(prog, args, iters=iters,
                                          device=dev)
        return out, agreed(wall), buffers

    oracle_final = measure(candidates[0])[0][0]

    def verify(out, plan):
        return _labels_equal(out[0], oracle_final)

    bucket = shape_bucket(T=parts.x.shape[1], P=mesh.shape[part_axis],
                          M=mesh.shape[model_axis])
    return sweep("comm", bucket, candidates, measure, verify, store=store,
                 backend=_backend(dev))


def tune_pipeline(batch, params, base: EnginePlan | None = None,
                  store: PlanStore | None = None,
                  iters: int = 1, *, device=None):
    """(tuned plan, {stage: TuneResult}): tune all three swept stages on
    ``device``.

    The join sweep runs end to end on ``batch``; the cluster sweep reuses
    the join oracle's dense similarity + slot table as its instance; the
    panel sweep runs on the positive entries of that matrix as a
    contribution list (row-major, ``np.nonzero``'s order).  The merged
    plan takes each stage's winner fields.
    """
    dev = resolve_device(device)
    batch = _on(batch, dev)
    base = (base or EnginePlan()).validate()
    oracle = run_dsc_lowerable(batch, params,
                               base.replace(mode="materialize"), device=dev)
    sim, table = oracle.sim, oracle.table
    results = {
        "join": tune_join(batch, params, base=base, store=store,
                          iters=iters, oracle=oracle, device=dev)}
    del oracle
    results["cluster"] = tune_cluster_tiles(sim, table, params, base=base,
                                            store=store, iters=iters,
                                            device=dev)
    src, dst = torch.nonzero(sim, as_tuple=True)
    contribs = (src.to(torch.int32), dst.to(torch.int32), sim[src, dst])
    del sim, src, dst
    results["similarity"] = tune_sim_panel(*contribs, table, params,
                                           base=base, store=store,
                                           iters=iters, device=dev)

    cw = results["cluster"].winner.plan
    sw = results["similarity"].winner.plan
    tuned = results["join"].winner.plan.replace(
        cluster_engine=cw.cluster_engine,
        cluster_use_kernel=cw.cluster_use_kernel,
        cluster_bu=cw.cluster_bu, cluster_bs=cw.cluster_bs,
        sim_panel=sw.sim_panel)
    return tuned, results
