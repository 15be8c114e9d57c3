"""The attention forward kernel (replaces ``flash_attention_fwd``,
``repro/kernels/attention/flash.py``)."""
