"""The plain reference of the benchmark: DSC (the paper's Algorithms 1-4)
in plain PyTorch and numpy, and the comparison that decides ``correct``.

It imports nothing of the program (``repro_torch``) and nothing of the
JAX package: it is handed the generated arrays and parameters and works
out every threshold and intermediate again.
"""
