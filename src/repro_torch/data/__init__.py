"""Synthetic trajectory generators of the PyTorch/CUDA port."""
