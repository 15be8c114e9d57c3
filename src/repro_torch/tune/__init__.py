"""Plan autotuning for the port's DSC engines (see ``repro_torch.tune.autotune``)."""
from repro_torch.tune.autotune import (CandidateRecord, PlanStore,  # noqa: F401
                                       TuneResult, plan_cache_key,
                                       shape_bucket, sweep,
                                       tune_cluster_tiles, tune_join,
                                       tune_pipeline, tune_sim_panel)
