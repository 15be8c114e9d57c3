"""Streaming ingestion + windowed incremental DSC of the port
(counterpart of ``repro.stream``; DESIGN.md §13).

``repro_torch.stream.ingest`` admits raw point records and quarantines
dirty ones; ``repro_torch.stream.window`` owns the bounded-lateness
watermark, the bounded staging queue and the backpressure policy (both
host numpy, copies of the reference's); ``repro_torch.stream.driver`` is
the long-running incremental DSC service, its standing state on the
card: per window advance a delta join of only the dirty rows (K1),
standing ``[S, K+1]`` neighbor-list merges, warm-started round-parallel
clustering, and periodic full-state snapshots in the reference's format,
so a killed service resumes bit-identically.
"""
from repro_torch.stream.ingest import (QUARANTINE_REASONS, Ingestor,
                                       PoisonRecord, Records, concat_records,
                                       take_records)
from repro_torch.stream.window import (BackpressureOverflow, WatermarkStall,
                                       WindowManager)
from repro_torch.stream.driver import (STREAM_SNAPSHOT_SCHEMA, StreamConfig,
                                       StreamDriver)

__all__ = [
    "Records", "concat_records", "take_records", "Ingestor",
    "PoisonRecord", "QUARANTINE_REASONS", "WindowManager",
    "BackpressureOverflow", "WatermarkStall", "StreamConfig",
    "StreamDriver", "STREAM_SNAPSHOT_SCHEMA",
]
