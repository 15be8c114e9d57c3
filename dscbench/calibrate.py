"""The readings that the limits of a cell's checks are set from, in one
process on the card.

    python3 dscbench/calibrate.py --workload brest.dense --seeds 1,2,3 \
        --control-seeds 1,2,3 [--jobs 2] [--out chiprun_out/cal.jsonl]

For each seed of ``--seeds``: one slice from that seed at the cell's size,
``--jobs`` jobs of the program on it through the timed path
(``harness.Program.job``), and the comparison of the last job's output
(and every job's labels) with the reference: the program's readings, the
lower ends.  For each seed of ``--control-seeds``: the reference computed
in bfloat16, the precision below the configuration's float32, in the
program's place: the control's readings, the upper ends.  One JSON line a
seed and side, with the job walls.  The benchmark's runs do not run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from dscbench import generator, harness
    from dscbench.reference import compare, pipeline
    cell = harness.load_cell(args.workload)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    sim_mode = cell.plan.get("sim_mode", "dense")
    k0 = int(cell.plan.get("sim_topk") or 32)
    out_f = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")
            out_f.flush()

    prog = harness.Program(cell, dev)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        sl = generator.make_slice(cell.config, seed)
        host, params = prog.host(sl)
        walls, labels = [], []
        for _ in range(args.jobs):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            s = time.perf_counter()
            lab, out, _ = prog.job(host, params, timed=False)
            walls.append((time.perf_counter() - s) * 1e3)
            labels.append(lab)
            if len(labels) < args.jobs:
                del out
        t1 = time.perf_counter()
        ref = pipeline.run(harness.tensors(sl, dev), sl.params)
        t_ref = time.perf_counter() - t1
        vals = compare.readings(out, ref, sim_mode, k0)
        vals["labels"] = float(max(compare.label_gaps(lab, ref)
                                   for lab in labels))
        emit({"side": "program", "workload": args.workload, "seed": seed,
              "readings": vals, "walls_ms": walls, "ref_s": t_ref,
              "rounds": out.rounds, "dispatches": out.dispatches,
              "k": out.sim_topk.k if out.sim_topk is not None else None,
              "alpha": ref.alpha, "n_pairs": ref.n_pairs,
              "n_best": ref.n_best,
              "alpha_degree_max": int(ref.alpha_degree.max(initial=0))})
        del out, ref
    for seed in controls:
        sl = generator.make_slice(cell.config, seed)
        arrays = harness.tensors(sl, dev)
        ref = pipeline.run(arrays, sl.params)
        try:
            low = pipeline.run(arrays, sl.params, dtype=torch.bfloat16)
            fake = compare.RefOutput(low, sim_mode, low.topk_k(k0))
            vals = compare.readings(fake, ref, sim_mode, k0)
            vals["labels"] = float(compare.label_gaps(
                (low.member_of, low.is_rep, low.is_outlier), ref))
            err = None
        except Exception as e:      # a control that crashes has failed
            vals, err = {}, repr(e)
        emit({"side": "control", "workload": args.workload, "seed": seed,
              "dtype": "bfloat16", "readings": vals, "error": err})
        del ref
    if out_f:
        out_f.close()
    print(f"calibrate: {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
