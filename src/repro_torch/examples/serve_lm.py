"""Batched-request serving example: wave-batched engine over a reduced
gemma2-family model (sliding-window + softcap attention exercised).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

On the card unless ``--device cpu`` asks for the CPU; with no card the
default raises.  ``main`` returns the served requests.
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (default: the card; raises "
                         "without one)")
    args = ap.parse_args(argv)
    done = serve_main(["--arch", "gemma2-2b", "--requests", "12",
                       "--slots", "4", "--prompt-len", "24",
                       "--max-new", "12", "--max-len", "64",
                       "--device", args.device])
    print(f"completed {len(done)} requests; first outputs:")
    for r in done[:3]:
        print(f"  req {r.uid}: {r.out}")
    return done


if __name__ == "__main__":
    main()
