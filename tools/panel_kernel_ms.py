#!/usr/bin/env python3
"""The port's kernels timed alone on one CUDA card, for the port in a given
``src`` directory, so that two versions of the port can be held against
each other within one run (parent, change, change, parent):

    python3 tools/panel_kernel_ms.py [--src DIR] [--label NAME]
                                     [--only PART [PART ...]]

(PART: fused, join, panels, cluster, lcss, jaccard, lists or rounds;
all eight by default.)

``--src`` defaults to this checkout's ``src``; the kernels build beside
it at first use.  Data and parameters are ``chip_smoke.brest_batch``'s
(dsc_brest: 4,096 AIS-like vessels x 128 points).

``fused``: K2 and K4 (the dense fused passes) on the launcher's layout,
K11 and K12 lane-sorted with the index's plan, each on the inputs of one
``run_dsc`` call of its dense fused path (that call's wall, join_vote
and similarity stages are reported too): CUDA events around 3 calls of
the public wrapper (the kernel, and this version's chunk time bounds or
checks), and a digest of each output (the sum of its 32-bit patterns as
int64), which two versions must share.  A process's first ``run_dsc``
call is the ``fused`` one (when it runs), so its join_vote shows what a
first call costs.

``join``: K1 on the launcher's layout and K10 lane-sorted with the
index's join plan (built once), each on the inputs of one ``run_dsc``
call of its materialize path (that call's wall and join_vote are
reported too): CUDA events around 3 calls of the public wrapper into
preallocated ``[P, C]`` outputs, and a digest of each output.

``panels``: K7 on the launcher's layout, K13 lane-sorted with the index's
plan, each on the middle panel of the top-K stream, with the
segmentation of one ``run_dsc`` call of its path (that call's wall and
similarity stage are reported too).

``cluster``: K5 at every round of one ``run_dsc`` call of the
materialize path (its round states recorded by
``chip_smoke.recorded_rounds``; that call's wall and cluster stage are
reported too), on that call's ``[S, S]`` matrix: CUDA events around 10
calls of the public wrapper a round, and a digest of each round's
output; then K6 on the same matrix, with that call's final
representatives, with a seeded half of the rows and with every row (R =
S): CUDA events around 20 calls of the public wrapper and around a CUDA
graph of them (the device time), and a digest of both outputs; and the
device time of one near-empty kernel (``torch.cuda._sleep(0)``) from a
CUDA graph, the floor of a launch.

``lcss``: K14 at full width (``chip_smoke.lcss_pairs``: 32,768 pairs of
128 x 128 points): CUDA events around 10 calls of ``lcss_wavefront``, and
a digest of the scores; the same with eps_t = -1 (the time test rejects
every cell: the DP alone) and eps_t = inf (every valid cell passes it).

``jaccard``: K3 through the public wrapper on the TSA2 words of the
fused path (K2's, raw), at dsc_brest and at dsc_sis (8,192 vessels),
each after one ``run_dsc`` call of that path (its wall and segment stage
are reported too): CUDA events around 10 calls, and a digest of ``d``.

``lists``: K9 through the public wrapper at every dispatch's K of one
``run_dsc`` call of the fused top-K path at dsc_brest (each dispatch's
claim-max inputs recorded on the host by ``chip_smoke.recorded_claims``,
so that call's wall and cluster stage include the copies): CUDA events
around 20 calls a dispatch and around a CUDA graph of them (the device
time: a small K's call is bound by the host), a digest of each output,
and the sums.

``rounds``: three ``run_dsc`` calls each of the dense fused and the
fused top-K paths at dsc_brest: per call the clustering stage and its
parts (the dotted ``cluster.*`` keys of ``stage_times``: the thresholds,
the round loop of a K5 / K8 launch and a host sync a round), the rounds,
and a digest of ``member_of`` and ``member_sim``.

"Alone" is ``chip_smoke.graph_ms`` of the panel's launch with its
operands prepared once and no slot-map check (K13 with the two zero
fills of its slabs): through ``prepare_sim_panel``'s prepared call where
the version has one, else through the launcher with the argument list of
that version's ``stjoin_sim_panel_fused_arrays``.  Both outputs are held
bitwise against the public wrapper, which is timed per call as well.
Prints the card line, then one JSON line.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PARTS = ("fused", "join", "panels", "cluster", "lcss", "jaccard", "lists",
         "rounds")


def panel_call(sj, batch, sub, ms, eps, p0, Sb, plan):
    """A function that launches the panel's kernel on prepared operands,
    and its ``(fwd, rev)`` output."""
    from repro_torch.core.similarity import slot_ids
    from repro_torch.kernels import launch
    if hasattr(sj, "prepare_sim_panel"):
        sweep = sj.sim_panel_sweep(batch, batch, sub, sub, ms, *eps,
                                   tile_ids=plan)
        out = []
        return lambda: out.append(sweep(p0, panel=Sb)), out
    T, M = batch.x.shape
    S = T * ms
    ref_ops, cand_ops = sj._flat_operands(
        *(batch.x, batch.y, batch.t, batch.valid, batch.traj_id) * 2)
    gid = slot_ids(sub, ms, S).to(torch.int32).contiguous()
    dev = batch.x.device
    name = "stjoin_sim_panel_fused" + ("" if plan is None else "_pruned")
    args = (*(t.data_ptr() for t in (*ref_ops, *cand_ops)), gid.data_ptr(),
            gid.data_ptr(), T, M, T, M, ms, p0, Sb, *sj._eps(*eps))
    fwd = torch.empty((Sb, S), dtype=torch.float32, device=dev)
    rev = torch.empty((Sb, S), dtype=torch.float32, device=dev)
    tail = ()
    if plan is not None:         # the panel's slices of the plan's entries
        lo, hi = p0 // ms, min(T - 1, (p0 + Sb - 1) // ms)
        fwd_pairs, blocks = plan.by_row
        rev_pairs, tiles = plan.by_tile
        f0, f1 = (int(i) for i in blocks.searchsorted([lo, hi + 1]))
        r0, r1 = (int(i) for i in tiles.searchsorted(
            [lo // sj.FUSED_BC, hi // sj.FUSED_BC + 1]))
        row = fwd_pairs.stride(0) * fwd_pairs.element_size()
        tail = (fwd_pairs.data_ptr() + f0 * row, f1 - f0,
                rev_pairs.data_ptr() + r0 * row, r1 - r0, lo, hi)

    def call():
        if plan is not None:     # cells of skipped pairs stay +0.0
            fwd.zero_()
            rev.zero_()
        launch(name, *args, *tail, fwd.data_ptr(), rev.data_ptr(),
               device=dev)
    call.operands = (ref_ops, cand_ops, gid)    # alive as long as call
    return call, [(fwd, rev)]


def measure(cs, batch, params, path):
    """One ``run_dsc`` call of ``path``, then its middle panel's kernel
    alone and through the public wrapper."""
    from repro_torch.core.dsc import plan_fused_tile_ids, run_dsc
    from repro_torch.core.similarity import plan_panel
    from repro_torch.kernels.stjoin import ops as sj
    plan = cs.kernel_plan(path)
    times = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_dsc(batch, params, plan=plan, device=batch.x.device,
                  stage_times=times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = params.max_subtrajs_per_traj
    S = batch.num_trajs * ms
    Sb = plan_panel(S)
    p0 = (S // Sb // 2) * Sb
    eps = (params.eps_sp, params.eps_t, params.delta_t)
    tiles, _ = plan_fused_tile_ids(batch, params, plan)
    sub = out.seg.sub_local
    call, got = panel_call(sj, batch, sub, ms, eps, p0, Sb, tiles)
    call()
    want = sj.stjoin_sim_panel_fused(batch, batch, sub, sub, ms, *eps,
                                     p0=p0, panel=Sb, tile_ids=tiles)
    cs.check(all(torch.equal(a, b) for a, b in zip(got[-1], want)),
             f"{path}: the prepared launch differs from the public wrapper")
    alone = cs.graph_ms(call)
    wrapper = cs.time_ms(lambda: sj.stjoin_sim_panel_fused(
        batch, batch, sub, sub, ms, *eps, p0=p0, panel=Sb, tile_ids=tiles),
        reps=10)
    return dict(path=path, p0=p0, panel=Sb, alone_ms=alone,
                wrapper_ms=wrapper, wall_s=wall,
                similarity_ms=times["similarity"], final_k=out.sim_topk.k,
                dispatches=out.dispatches,
                clusters=int(out.result.is_rep.sum()))


def digest(t) -> int:
    """The sum of a 32-bit tensor's bit patterns (of a bool tensor: its set
    positions, from 1), as int64: equal outputs give equal digests."""
    if t.dtype == torch.bool:
        return int((torch.nonzero(t.flatten()) + 1).sum())
    return int(t.contiguous().view(torch.int32).long().sum())


def cluster_measure(cs, batch, params):
    """One ``run_dsc`` call of the materialize path, its round states
    recorded, then K5 alone at every round on that call's matrix, and K6 on
    its final representatives, on a seeded half of the rows and on every
    row."""
    from repro_torch.core.clustering import visit_order
    from repro_torch.core.dsc import run_dsc
    from repro_torch.kernels.cluster.ops import (cluster_assign,
                                                 cluster_round_scan)
    times = {}
    with cs.recorded_rounds() as states:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_dsc(batch, params, plan=cs.kernel_plan("materialize"),
                      device=batch.x.device, stage_times=times)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sim, alpha = out.sim, out.result.alpha_used
    _, rank = visit_order(out.table)
    rounds = []
    for unres, rep in states:
        call = lambda: cluster_round_scan(sim, rank, unres, rep, alpha)
        b, c = call()
        rounds.append(dict(active=int((unres | rep).sum()),
                           ms=cs.time_ms(call, reps=10),
                           digest=[digest(b), digest(c)]))
    g = torch.Generator(device=sim.device).manual_seed(0)
    half = torch.rand(sim.shape[0], generator=g, device=sim.device) < 0.5
    k6, a = {}, float(alpha)     # by value: a parent's wrapper syncs on it
    every = torch.ones_like(half)
    for name, rep in (("final", out.result.is_rep), ("half", half),
                      ("all", every)):
        call = lambda: cluster_assign(sim, rank, rep, out.table.valid, a)
        w, slot = call()
        k6[name] = dict(R=int(rep.sum()), ms=cs.time_ms(call, reps=20),
                        device_ms=cs.graph_ms(call),
                        digest=[digest(w), digest(slot)])
    return dict(wall_s=wall, cluster_ms=times["cluster"],
                clusters=int(out.result.is_rep.sum()), rounds=rounds,
                K5_sum_ms=sum(r["ms"] for r in rounds), K6=k6,
                launch_floor_ms=cs.graph_ms(lambda: torch.cuda._sleep(0)))


def lcss_measure(cs, dev):
    """K14 alone at full width, timed and digested; then at the same
    points with eps_t = -1 (every cell rejected by the time test: the DP
    alone) and eps_t = inf (every valid cell past it)."""
    from repro_torch.kernels.lcss import ops as lo
    ops, (eps_sp, eps_t) = cs.lcss_pairs(dev)
    res = dict(pairs=ops[0].shape[0])
    for name, et in (("K14", eps_t), ("K14_no_cell_timed", -1.0),
                     ("K14_every_cell_timed", float("inf"))):
        call = lambda: lo.lcss_wavefront(*ops, eps_sp, et)
        res[name + "_digest"] = digest(call())
        res[name] = cs.time_ms(call, reps=10)
    return res


def jaccard_measure(cs, batch, params):
    """One ``run_dsc`` call of the fused path, then K3 through the public
    wrapper on that path's TSA2 words (K2's), timed and digested."""
    from repro_torch.core.dsc import run_dsc
    from repro_torch.kernels.jaccard.ops import window_jaccard
    from repro_torch.kernels.stjoin import ops as sj
    times = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_dsc(batch, params, plan=cs.kernel_plan("fused"),
                  device=batch.x.device, stage_times=times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    clusters = int(out.result.is_rep.sum())
    del out
    T, M = batch.x.shape
    arrs = (batch.x, batch.y, batch.t, batch.valid, batch.traj_id) * 2
    eps = (params.eps_sp, params.eps_t, params.delta_t)
    words = sj.stjoin_vote_fused_arrays(*arrs, *eps)[1].view(T, M, -1)
    call = lambda: window_jaccard(words, batch.valid, w=params.w)
    return dict(T=T, wall_s=wall, segment_ms=times["segment"],
                clusters=clusters, digest=digest(call()),
                K3=cs.time_ms(call, reps=10))


def lists_measure(cs, batch, params):
    """One ``run_dsc`` call of the fused top-K path with each dispatch's
    claim-max inputs recorded, then K9 at every dispatch's K, timed and
    digested."""
    from repro_torch.core.dsc import run_dsc
    from repro_torch.kernels.cluster.ops import topk_cluster_assign
    times = {}
    dev = batch.x.device
    with cs.recorded_claims() as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_dsc(batch, params, plan=cs.kernel_plan("fused_topk"),
                      device=dev, stage_times=times)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    clusters = int(out.result.is_rep.sum())
    del out
    per = []
    for rec in calls:
        ops, alpha = [t.to(dev) for t in rec[:5]], rec[5]
        fn = lambda: topk_cluster_assign(*ops, alpha)
        w, slot = fn()
        per.append(dict(K=ops[0].shape[1], ms=cs.time_ms(fn, reps=20),
                        device_ms=cs.graph_ms(fn),
                        digest=[digest(w), digest(slot)]))
    return dict(wall_s=wall, cluster_ms=times["cluster"], clusters=clusters,
                dispatches=per, K9_sum_ms=sum(p["ms"] for p in per),
                K9_sum_device_ms=sum(p["device_ms"] for p in per))


def rounds_measure(cs, batch, params, reps: int = 3):
    """``reps`` calls of ``run_dsc`` on the dense fused and the fused top-K
    paths: each call's clustering stage, its parts, rounds and a digest
    of the labels."""
    from repro_torch.core.dsc import run_dsc
    res = {}
    for path in ("fused", "fused_topk"):
        calls = []
        for _ in range(reps):
            times = {}
            out = run_dsc(batch, params, plan=cs.kernel_plan(path),
                          device=batch.x.device, stage_times=times)
            calls.append(dict(
                cluster_ms=times["cluster"], rounds=out.rounds,
                **{k.split(".")[1] + "_ms": v for k, v in times.items()
                   if k.startswith("cluster.")},
                digest=[digest(out.result.member_of),
                        digest(out.result.member_sim)]))
            del out
        res[path] = calls
    return res


def fused_measure(cs, batch, params, path):
    """One ``run_dsc`` call of the dense fused ``path``, then its join_vote
    and similarity passes (K2 and K4, or K11 and K12 with the index) on
    that call's inputs, timed and digested."""
    from repro_torch.core.dsc import plan_fused_tile_ids, run_dsc
    from repro_torch.kernels.stjoin import ops as sj
    plan = cs.kernel_plan(path)
    times = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_dsc(batch, params, plan=plan, device=batch.x.device,
                  stage_times=times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = params.max_subtrajs_per_traj
    eps = (params.eps_sp, params.eps_t, params.delta_t)
    tiles, _ = plan_fused_tile_ids(batch, params, plan)
    arrs = (batch.x, batch.y, batch.t, batch.valid, batch.traj_id) * 2
    sub = out.seg.sub_local
    vote = lambda: sj.stjoin_vote_fused_arrays(*arrs, *eps, tile_ids=tiles)
    sim = lambda: sj.stjoin_sim_fused(batch, batch, sub, sub, ms, *eps,
                                      tile_ids=tiles)
    v, w = vote()
    sums = dict(vote=digest(v), words=digest(w))
    del v, w
    sums["raw"] = digest(sim())
    names = ("K11", "K12") if tiles is not None else ("K2", "K4")
    return dict(path=path, wall_s=wall, join_vote_ms=times["join_vote"],
                similarity_ms=times["similarity"],
                clusters=int(out.result.is_rep.sum()), digest=sums,
                **{names[0]: cs.time_ms(vote, reps=3),
                   names[1]: cs.time_ms(sim, reps=3)})


def join_measure(cs, batch, params, path):
    """One ``run_dsc`` call of the materialize ``path``, then its join
    kernel (K1, or K10 with the index's plan) on that call's inputs, timed
    and digested."""
    from repro_torch.core.dsc import run_dsc
    from repro_torch.kernels.stjoin import ops as sj
    times = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_dsc(batch, params, plan=cs.kernel_plan(path),
                  device=batch.x.device, stage_times=times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    clusters = int(out.result.is_rep.sum())
    del out
    eps = (params.eps_sp, params.eps_t)
    ref_ops, cand_ops = sj._flat_operands(
        *(batch.x, batch.y, batch.t, batch.valid, batch.traj_id) * 2)
    P, C = ref_ops[0].shape[0], cand_ops[0].shape[0]
    dev = batch.x.device
    w = torch.empty((P, C), dtype=torch.float32, device=dev)
    i = torch.empty((P, C), dtype=torch.int32, device=dev)
    if path.endswith("+index"):
        mask, counts, _ = sj.plan_join_index(batch, batch, *eps)
        ids = sj._compact(mask, counts, None, "pruned join")
        name, call = "K10", lambda: sj.stjoin_best_match_pruned(
            *ref_ops, *cand_ops, ids, *eps, out_w=w, out_idx=i)
    else:
        name, call = "K1", lambda: sj.stjoin_best_match(
            *ref_ops, *cand_ops, *eps, out_w=w, out_idx=i)
    call()
    sums = dict(best_w=digest(w), best_idx=digest(i))
    return dict(path=path, wall_s=wall, join_vote_ms=times["join_vote"],
                clusters=clusters, digest=sums,
                **{name: cs.time_ms(call, reps=3)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory of the port to time")
    ap.add_argument("--label", default="", help="a name for the JSON line")
    ap.add_argument("--only", nargs="+", default=PARTS, choices=PARTS,
                    help="time only these parts: the dense fused passes, "
                         "the materialize join, the top-K panel passes, K5 "
                         "over the clustering rounds and K6, K14, K3, K9 at "
                         "every top-K dispatch, the clustering stage's "
                         "parts (default: all eight)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("panel_kernel_ms: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch import kernels
    dev = torch.device("cuda")
    card = cs.gpu_line()
    kernels.library()
    brest = cs.brest_batch(4096, dev)
    lanes = cs.brest_batch(4096, dev, sort_by_lane=True)
    res = dict(label=args.label, src=args.src, card=card)
    if "fused" in args.only:
        res["fused"] = fused_measure(cs, *brest, "fused")
        res["fused+index"] = fused_measure(cs, *lanes, "fused+index")
    if "join" in args.only:
        res["materialize"] = join_measure(cs, *brest, "materialize")
        res["materialize+index"] = join_measure(cs, *lanes,
                                                "materialize+index")
        torch.cuda.empty_cache()
    if "panels" in args.only:
        res["K7"] = measure(cs, *brest, "fused_topk")
        res["K13"] = measure(cs, *lanes, "fused_topk+index")
    if "cluster" in args.only:
        res["cluster"] = cluster_measure(cs, *brest)
        torch.cuda.empty_cache()
    if "lcss" in args.only:
        res["lcss"] = lcss_measure(cs, dev)
    if "lists" in args.only:
        res["lists"] = lists_measure(cs, *brest)
    if "rounds" in args.only:
        res["rounds"] = rounds_measure(cs, *brest)
    if "jaccard" in args.only:
        res["jaccard"] = jaccard_measure(cs, *brest)
        del brest, lanes
        torch.cuda.empty_cache()
        res["jaccard_sis"] = jaccard_measure(cs, *cs.brest_batch(8192, dev))
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
