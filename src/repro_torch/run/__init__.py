"""Resilient execution layer of the port (counterpart of ``repro.run``):
the stage-graph runner and deterministic faults.

``repro_torch.run.resilient`` decomposes the DSC pipeline into
checkpointable stage boundaries and resumes from the first incomplete
stage; ``repro_torch.run.faults`` scripts deterministic failures (crash,
transient error, checkpoint corruption, slowdown, stream chaos) against
those boundaries so the recovery paths are testable without real crashes
(DESIGN.md §10); ``repro_torch.run.rebalance`` is the straggler policy
(DESIGN.md §11).  ``EXIT_CODES`` is the process exit code of each failure
class, which ``repro_torch.launch.run_dsc`` returns.
"""
from repro_torch.run.faults import (FaultInjector, FaultPlan, InjectedCrash,
                                    RetriesExhausted, TransientFault,
                                    retry_with_backoff)
from repro_torch.run.rebalance import RebalancePolicy
from repro_torch.run.resilient import (EXIT_CODES, TELEMETRY_SCHEMA,
                                       CheckpointCorruption,
                                       OverflowViolation, ResilientResult,
                                       Telemetry, read_telemetry,
                                       run_resilient,
                                       run_resilient_distributed)

__all__ = [
    "FaultPlan", "FaultInjector", "InjectedCrash", "TransientFault",
    "RetriesExhausted", "retry_with_backoff", "CheckpointCorruption",
    "OverflowViolation", "RebalancePolicy", "ResilientResult",
    "run_resilient", "run_resilient_distributed", "read_telemetry",
    "Telemetry", "TELEMETRY_SCHEMA", "EXIT_CODES",
]
