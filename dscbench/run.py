"""Run one cell of the benchmark once and print its result line.

    python3 dscbench/run.py --workload brest.dense --seed 7 --seconds 10 --trace 0

From the root of a checkout: the system under test is ``repro_torch``
from its ``src/``, on the card (this exits with code 2 and prints no
result where there is none, or fewer cards than the cell asks for).  The
last line of standard output is the result, a JSON object; the last lines
of standard error give each checked reading beside its limit.  With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled window.

Every cache the program builds goes under ``build/`` in the checkout.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "dscbench"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="cell name")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    from dscbench import harness
    cell = harness.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"dscbench: cell {args.workload} needs {cell.chips} CUDA "
              f"card(s); {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, lines = harness.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace),
                                     torch.device("cuda", 0), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"dscbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
