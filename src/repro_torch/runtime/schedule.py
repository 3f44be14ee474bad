"""The boundary/interior step schedule (paper Fig 5.1) as a four-phase
object, its calibration report, and the dispatch ledger (numpy).

    1. boundary   — pack what must cross a link (the halo index set on the
                    blocked engine);
    2. exchange   — the halo exchange, issued before interior work;
    3. interior   — volume compute with no halo dependence;
    4. correction — fold the received halo into the partial result.

``CalibrationReport`` holds per-partition seconds for each phase and the
overlap-aware step model ``t = boundary + max(interior, transfer) +
correction`` the load-balance planner consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

__all__ = ["StepSchedule", "CalibrationReport", "DispatchStats"]


@dataclasses.dataclass
class DispatchStats:
    """Runs vs steps advanced by a fused step driver.

    ``record`` is called once per ``run`` call; ``observe_chunks`` counts
    observed chunks (``run_observed`` calls); ``kernel_launches`` holds the
    per-kernel launches of ONE rhs evaluation of the last run — the
    envelope layout must read ``{"volume": 1, "surface": 1}``."""

    dispatches: int = 0
    steps_run: int = 0
    observe_chunks: int = 0
    kernel_launches: dict = dataclasses.field(default_factory=dict)

    def record(self, dispatches: int, steps: int) -> None:
        self.dispatches += int(dispatches)
        self.steps_run += int(steps)

    def record_chunk(self, n: int = 1) -> None:
        """Ledger one observed chunk (a ``run_observed`` call)."""
        self.observe_chunks += int(n)

    def record_launches(self, counts: dict) -> None:
        """Install the per-kernel launches per rhs of the run that just
        finished (replaces, not accumulates)."""
        self.kernel_launches = {str(k): int(v) for k, v in counts.items()}


@dataclasses.dataclass
class StepSchedule:
    """One RHS evaluation as four named phases over an opaque ``state``:

      * ``boundary(state) -> send``
      * ``exchange(send, state) -> recv``
      * ``interior(state) -> partial``
      * ``correction(partial, recv, state) -> out``
    """

    boundary: Callable[[Any], Any]
    exchange: Callable[[Any, Any], Any]
    interior: Callable[[Any], Any]
    correction: Callable[[Any, Any, Any], Any]

    def rhs(self, state):
        """Composed evaluation, exchange issued before interior."""
        send = self.boundary(state)
        recv = self.exchange(send, state)
        part = self.interior(state)
        return self.correction(part, recv, state)

    def rhs_many(self, states):
        """Phase-major composition over independent per-block states: every
        pack and exchange is issued before any interior compute.  The result
        is element-wise identical to mapping :meth:`rhs` over ``states``."""
        sends = [self.boundary(st) for st in states]
        recvs = [self.exchange(send, st) for send, st in zip(sends, states)]
        parts = [self.interior(st) for st in states]
        return [
            self.correction(part, recv, st)
            for part, recv, st in zip(parts, recvs, states)
        ]


def _zeros_like(a: np.ndarray) -> np.ndarray:
    return np.zeros_like(np.asarray(a, dtype=np.float64))


@dataclasses.dataclass(frozen=True)
class CalibrationReport:
    """Per-partition seconds for the four schedule phases (paper sec. 5.6).

    ``boundary_s`` is face-flux work wherever it executes; ``correction_s``
    the residual fold/assemble cost; ``transfer_s`` the halo exchange, the
    component the overlap schedule can hide."""

    boundary_s: np.ndarray
    interior_s: np.ndarray
    transfer_s: np.ndarray
    correction_s: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.correction_s is None:
            object.__setattr__(self, "correction_s", _zeros_like(self.boundary_s))

    @property
    def step_s(self) -> np.ndarray:
        """Sequential step: every phase back-to-back (no overlap)."""
        return self.boundary_s + self.interior_s + self.transfer_s + self.correction_s

    @property
    def overlapped_s(self) -> np.ndarray:
        """Overlap-aware step: interior hides the transfer (Fig 5.1)."""
        return (
            self.boundary_s
            + np.maximum(self.interior_s, self.transfer_s)
            + self.correction_s
        )

    @property
    def hidden_s(self) -> np.ndarray:
        """Transfer seconds hidden under interior compute per step."""
        return np.minimum(self.interior_s, self.transfer_s)

    @property
    def overlap_efficiency(self) -> np.ndarray:
        """hidden transfer / total transfer in [0, 1] (1.0 where there is no
        transfer)."""
        t = np.asarray(self.transfer_s, dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            eff = np.where(t > 0, self.hidden_s / np.where(t > 0, t, 1.0), 1.0)
        return eff

    @staticmethod
    def from_totals(step_s: Sequence[float]) -> "CalibrationReport":
        """A report from component-unresolved per-partition step seconds; the
        total is carried in ``interior_s``."""
        t = np.asarray(step_s, dtype=np.float64)
        z = np.zeros_like(t)
        return CalibrationReport(boundary_s=z, interior_s=t, transfer_s=z.copy(),
                                 correction_s=z.copy())

    @staticmethod
    def from_chunk(
        wall_s: float, shares: Sequence[float], n_steps: int
    ) -> "CalibrationReport":
        """A report from one observed chunk: the chunk's wall seconds per
        step, split across partitions in proportion to ``shares`` (uniform
        when they are all zero).  Component-unresolved."""
        s = np.asarray(shares, dtype=np.float64)
        if s.ndim != 1 or len(s) == 0:
            raise ValueError(f"shares must be a non-empty vector, got shape {s.shape}")
        s = np.maximum(s, 0.0)
        tot = s.sum()
        s = s / tot if tot > 0 else np.full(len(s), 1.0 / len(s))
        per_step = float(wall_s) / max(1, int(n_steps))
        return CalibrationReport.from_totals(per_step * s)

    def time_models(
        self,
        counts: Sequence[int],
        overlap: bool = True,
        transfer_exponent: float = 2.0 / 3.0,
    ) -> List[Callable[[float], float]]:
        """Per-partition ``t_p(k)`` callables for the load-balance solvers:
        compute phases scale linearly from the calibrated counts, transfer
        with ``k**(2/3)``; with ``overlap`` the model is ``boundary +
        max(interior, transfer) + correction``.  A partition with no
        calibrated work gets the fleet-mean phase times as a prior."""
        counts = np.asarray(counts, dtype=np.float64)
        P = len(counts)
        phases = np.stack([np.asarray(self.boundary_s, dtype=np.float64),
                           np.asarray(self.interior_s, dtype=np.float64),
                           np.asarray(self.transfer_s, dtype=np.float64),
                           np.asarray(self.correction_s, dtype=np.float64)])
        alive = phases.sum(axis=0) > 0
        if alive.any() and not alive.all():
            prior = phases[:, alive].mean(axis=1)
            c_prior = max(1.0, float(counts[alive].mean()))
            phases = phases.copy()
            phases[:, ~alive] = prior[:, None]
            counts = np.where(alive, counts, c_prior)
        fns: List[Callable[[float], float]] = []
        for p in range(P):
            c = max(1.0, float(counts[p]))
            b, i = float(phases[0, p]), float(phases[1, p])
            x, co = float(phases[2, p]), float(phases[3, p])

            def t(k: float, b=b, i=i, x=x, co=co, c=c) -> float:
                k = float(k)
                if k <= 0:
                    return 0.0
                scale = k / c
                xfer = x * scale**transfer_exponent
                compute = i * scale
                hot = max(compute, xfer) if overlap else compute + xfer
                return b * scale + hot + co * scale

            fns.append(t)
        return fns

    def summary(self) -> str:
        rows = []
        eff = self.overlap_efficiency
        for p in range(len(self.boundary_s)):
            rows.append(
                f"p{p}: boundary={self.boundary_s[p] * 1e3:.2f}ms "
                f"interior={self.interior_s[p] * 1e3:.2f}ms "
                f"transfer={self.transfer_s[p] * 1e3:.2f}ms "
                f"correction={self.correction_s[p] * 1e3:.2f}ms "
                f"overlapped={self.overlapped_s[p] * 1e3:.2f}ms "
                f"overlap-eff={eff[p] * 100:.0f}%"
            )
        return "\n".join(rows)
