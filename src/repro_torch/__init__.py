"""Scalable Distributed Subtrajectory Clustering on PyTorch and CUDA.

The port of the JAX package ``repro`` to one NVIDIA H100: the same stages
(join, voting, segmentation, similarity, clustering) with the same
contracts, the TPU kernels rewritten as hand-written CUDA kernels for
``sm_90a`` (``repro_torch.kernels``).  Entry points run on the card unless
the caller passes ``device="cpu"``; they never fall back on their own.
"""
