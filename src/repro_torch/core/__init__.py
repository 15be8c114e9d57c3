"""PyTorch/CUDA port of the DSC pipeline: core stages."""
