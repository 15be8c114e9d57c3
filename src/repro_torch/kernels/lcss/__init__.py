"""The exact LCSS kernel (replaces ``lcss_pallas`` and its host
``shear_weights``, ``repro/kernels/lcss/lcss.py``)."""
