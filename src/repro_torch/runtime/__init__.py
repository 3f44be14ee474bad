"""Runtime: the online nested-partition executor, the blocked DG engine, its
envelope-layout step pipeline, and the four-phase step schedule."""

from repro_torch.runtime.executor import (
    BlockedDGEngine,
    NestedPartitionExecutor,
    Plan,
    bucket_counts,
    pad_to_bucket,
)
from repro_torch.runtime.pipeline import FusedStepPipeline
from repro_torch.runtime.schedule import CalibrationReport, DispatchStats, StepSchedule

__all__ = [
    "BlockedDGEngine",
    "NestedPartitionExecutor",
    "Plan",
    "bucket_counts",
    "pad_to_bucket",
    "FusedStepPipeline",
    "CalibrationReport",
    "DispatchStats",
    "StepSchedule",
]
