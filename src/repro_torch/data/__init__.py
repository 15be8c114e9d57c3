"""Synthetic trajectory generators and the LM token pipeline of the
PyTorch/CUDA port."""
