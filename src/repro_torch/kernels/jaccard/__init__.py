"""The TSA2 Jaccard kernel (replaces ``jaccard_pallas``,
``repro/kernels/jaccard/jaccard.py``)."""
