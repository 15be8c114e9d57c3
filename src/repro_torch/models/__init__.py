"""The LM stack of the port (``repro.models``): configs, layers, the
linear-attention core, Mamba-2, RWKV-6, MoE and the unified decoder."""
