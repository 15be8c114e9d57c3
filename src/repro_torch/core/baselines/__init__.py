"""Comparison baselines from the paper's experimental study (Sec. 6.2)
(counterpart of ``repro.core.baselines``).

These are *centralized* algorithms (the paper's point is precisely that they
do not scale); they are implemented host-side in NumPy, faithful to their
original definitions (S2T's DSC core runs in PyTorch on the batch's
device); the reference's versions are what ``benchmarks/fig6_groundtruth.py``
and ``benchmarks/fig7_rmse.py`` read:

  traclus  — TraClus [9]: MDL partitioning + segment-DBSCAN + representative
  s2t      — S2T-Clustering [20]: voting segmentation + SaCO seeds/clusters
  toptics  — T-OPTICS [13]: whole-trajectory OPTICS
"""
