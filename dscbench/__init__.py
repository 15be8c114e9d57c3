"""The benchmark of the PyTorch and CUDA port: DSC clustering jobs on one
card, driven by the data files beside this one (``run.py`` runs a cell)."""
