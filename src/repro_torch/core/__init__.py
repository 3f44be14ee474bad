"""Numpy planners of the nested partition (copies of ``repro.core``'s
morton, partition and load_balance modules, held equal to them by tests)."""

from repro_torch.core.load_balance import (
    SplitResult,
    rebalance_from_measurements,
    solve_multiway,
)
from repro_torch.core.morton import curve_rank, morton_order
from repro_torch.core.partition import (
    NestedPartition,
    NodePartition,
    build_nested_partition,
    face_neighbors,
    splice,
)

__all__ = [
    "SplitResult",
    "rebalance_from_measurements",
    "solve_multiway",
    "curve_rank",
    "morton_order",
    "NestedPartition",
    "NodePartition",
    "build_nested_partition",
    "face_neighbors",
    "splice",
]
