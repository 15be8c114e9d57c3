"""The round-parallel clustering kernels (replace ``round_scan_pallas``
and ``assign_pallas``, ``repro/kernels/cluster/cluster.py``)."""
