"""Heterogeneous load balancing: the equalization solve (numpy).

Balance is optimal when every partition finishes together.
``solve_multiway`` waterfills a common finish time across n partitions, and
``rebalance_from_measurements`` is the same equalizer fed with measured step
times (straggler mitigation).  The two-way host/accelerator and hierarchical
solves wait for the simulated-cluster slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

__all__ = [
    "SplitResult",
    "solve_multiway",
    "rebalance_from_measurements",
]


@dataclasses.dataclass(frozen=True)
class SplitResult:
    counts: tuple  # work items per partition
    times: tuple  # predicted completion time per partition
    ratio: float  # counts[accel] / counts[host] for two-way splits

    @property
    def makespan(self) -> float:
        return max(self.times)


def solve_multiway(
    time_fns: Sequence[Callable[[float], float]],
    K: int,
    integer: bool = True,
) -> SplitResult:
    """Equalize completion time across n partitions by waterfilling: find the
    common finish time T with sum_i K_i(T) = K, where K_i(T) inverts the
    nondecreasing t_i by bisection."""
    n = len(time_fns)
    if n == 0:
        raise ValueError("need at least one partition")

    def k_of_t(t_fn: Callable[[float], float], T: float) -> float:
        if t_fn(0) > T:
            return 0.0
        lo, hi = 0.0, 1.0
        while t_fn(hi) <= T and hi < 1e15:
            hi *= 2
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            if t_fn(mid) <= T:
                lo = mid
            else:
                hi = mid
        return lo

    T_hi = max(t_fn(K) for t_fn in time_fns) + 1e-12
    T_lo = 0.0
    for _ in range(80):
        T_mid = 0.5 * (T_lo + T_hi)
        total = sum(k_of_t(f, T_mid) for f in time_fns)
        if total >= K:
            T_hi = T_mid
        else:
            T_lo = T_mid
    ks = np.array([k_of_t(f, T_hi) for f in time_fns])
    if ks.sum() <= 0:
        ks = np.ones(n)
    if integer:
        ideal = K * ks / ks.sum()
        counts = np.floor(ideal).astype(int)
        rem = K - counts.sum()
        order = np.argsort(-(ideal - counts))
        counts[order[:rem]] += 1
    else:
        counts = K * ks / ks.sum()
    times = tuple(float(time_fns[i](counts[i])) for i in range(n))
    ratio = counts[1] / counts[0] if n == 2 and counts[0] > 0 else float("nan")
    return SplitResult(counts=tuple(int(c) if integer else float(c) for c in counts), times=times, ratio=ratio)


def rebalance_from_measurements(
    current_counts: Sequence[int],
    measured_times: Sequence[float],
    smoothing: float = 0.5,
    prev_weights: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Online re-balance: per-partition throughput from the measured step
    times gives new weights that equalize predicted times, blended with
    ``prev_weights`` (EWMA, ``smoothing`` on the new side) so one noisy step
    cannot thrash the split."""
    counts = np.asarray(current_counts, dtype=np.float64)
    times = np.asarray(measured_times, dtype=np.float64)
    if (times <= 0).any():
        raise ValueError("measured times must be positive")
    throughput = counts / times
    if (throughput <= 0).any():
        pos = throughput[throughput > 0]
        if len(pos) == 0:
            prior = np.ones_like(throughput)
            if prev_weights is not None:
                prior = np.asarray(prev_weights, dtype=np.float64)
            return prior / prior.sum()
        throughput = np.where(throughput > 0, throughput, pos.mean())
    new_w = throughput / throughput.sum()
    if prev_weights is not None:
        prev = np.asarray(prev_weights, dtype=np.float64)
        prev = prev / prev.sum()
        new_w = smoothing * new_w + (1.0 - smoothing) * prev
    return new_w / new_w.sum()
