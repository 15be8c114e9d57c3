"""End-to-end LM training driver: train a model for a few hundred steps
with checkpointing, and verify the loss drops.

Default is a reduced smollm-family config; ``--preset 100m`` selects the
full smollm-360m width (the training launcher's ``--full``), for the card.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 [--device cpu]

On the card unless ``--device cpu`` asks for the CPU; with no card the
default raises.  Checkpoints go to ``--ckpt-dir``, by default a fresh
temporary directory, so a run never starts from another run's files.
``main`` returns the losses.
"""
import argparse
import tempfile

from repro_torch.kernels import resolve_device
from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--preset", choices=["tiny", "100m"], default="tiny")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (default: the card; "
                         "raises without one)")
    args = ap.parse_args(argv)
    resolve_device(args.device)         # no card: raise before any work
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(
        prefix="repro_torch_train_lm_")

    argv = ["--arch", args.arch, "--steps", str(args.steps),
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "100",
            "--batch", "8", "--seq", "128", "--lr", "3e-3",
            "--device", args.device]
    if args.preset == "100m":
        # the full smollm-360m width: for the card
        argv += ["--full"]
        print("NOTE: --preset 100m is sized for accelerators; on the CPU "
              "it will be slow.")
    losses = train_main(argv)
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    print(f"loss: {first:.3f} -> {last:.3f}")
    assert last < first, "training did not reduce loss"
    print("OK: loss decreased; checkpoint written to", ckpt_dir)
    return losses


if __name__ == "__main__":
    main()
