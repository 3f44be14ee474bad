"""Online auto-rebalancing nested-partition executor and the blocked DG
engine, in PyTorch.

``NestedPartitionExecutor`` (numpy) closes the paper's calibration loop:
measured per-partition step times feed the equalizer
(``rebalance_from_measurements``), the split is rounded
to ``bucket`` multiples (``bucket_counts``), and the ``NestedPartition`` is
re-spliced; resplice hooks let engines rebuild their tables.

``BlockedDGEngine`` executes a ``DGSolver`` rhs as per-partition element
blocks with halo gathers, each block a ``StepSchedule`` instantiation:
*exchange* gathers the halo, *interior* runs the volume kernel on the
block's own elements, *correction* runs the face flux on the assembled
block and folds it in.  The partition is a reordering, never an
approximation: blocked and flat runs agree to rounding.

Without ``grid_dims`` the executor splits a plain run of items (the rows
of a serving batch) into contiguous chunks; ``plan_from_report`` solves the
split from a phase-resolved ``CalibrationReport`` (serving calibrates
prefill as the boundary phase and decode as the interior phase).

Not in this slice: the persistent plan cache (``plan_cache_dir`` raises
``NotImplementedError``) with its plan keys; predicted times per plan and
the ``calibrate(measure_fn)`` loop, which wait for the cost model; modeled
time models, accelerator counts, ejection/readmission and state snapshots
(the simulated cluster and the fault-tolerance layer); the step driver
``drive`` (the LM training launcher).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.load_balance import rebalance_from_measurements, solve_multiway
from repro_torch.core.partition import NestedPartition, build_nested_partition, splice
from repro_torch.device import synchronize
from repro_torch.dg.operators import surface_rhs, volume_rhs_impl
from repro_torch.dg.rk import lsrk45_step
from repro_torch.runtime.pipeline import FusedStepPipeline
from repro_torch.runtime.schedule import CalibrationReport, StepSchedule

__all__ = [
    "Plan",
    "CalibrationReport",
    "StepSchedule",
    "NestedPartitionExecutor",
    "BlockedDGEngine",
    "bucket_counts",
    "pad_to_bucket",
]


def bucket_counts(counts: Sequence[int], bucket: int) -> np.ndarray:
    """Round per-partition counts to multiples of ``bucket`` while conserving
    the total (largest-remainder on bucket units); the sub-bucket tail goes
    to the largest partition."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if bucket <= 1 or total == 0:
        return counts.copy()
    units = total // bucket
    if units == 0:
        out = np.zeros_like(counts)
        out[int(np.argmax(counts))] = total
        return out
    ideal = units * counts / total
    base = np.floor(ideal).astype(np.int64)
    rem = units - int(base.sum())
    order = np.argsort(-(ideal - base), kind="stable")
    base[order[:rem]] += 1
    out = base * bucket
    out[int(np.argmax(counts))] += total - int(out.sum())
    if out.sum() != total or (out < 0).any():
        raise AssertionError(f"bucket_counts broke the total: {out} vs {total}")
    return out


def pad_to_bucket(n: int, bucket: int) -> int:
    """Padded size for a chunk of ``n`` items."""
    if bucket <= 1 or n == 0:
        return n
    return int(-(-n // bucket) * bucket)


@dataclasses.dataclass(frozen=True)
class Plan:
    """A solved split: normalized work weights and bucketed counts."""

    weights: np.ndarray  # (P,) normalized
    counts: np.ndarray  # (P,) integer, bucketed, sums to K
    round: int = 0


class NestedPartitionExecutor:
    """Closes the paper's calibration loop at runtime (numpy): ``observe`` is
    fed per-partition step seconds (a ``BlockedDGEngine`` calibration, an
    observed chunk or a serving calibration), ``rebalance`` or
    ``plan_from_report`` turns them into a new bucketed split, and the
    resplice hooks rebuild the engines' tables.  With ``grid_dims`` the split
    is a nested partition of the element grid; without, contiguous chunks of
    ``n_items``.

    ``inject_straggler(p, factor)`` multiplies partition ``p``'s observed
    times (applied once, inside ``observe``)."""

    def __init__(
        self,
        n_items: int,
        n_partitions: int,
        *,
        grid_dims: Optional[tuple] = None,
        bucket: int = 16,
        smoothing: float = 0.5,
        rebalance_every: int = 10,
        plan_cache_dir: Optional[str] = None,
    ):
        if plan_cache_dir is not None:
            raise NotImplementedError("the persistent plan cache is not ported yet")
        if grid_dims is not None and n_items != int(np.prod(grid_dims)):
            raise ValueError(f"n_items={n_items} != prod(grid_dims)={int(np.prod(grid_dims))}")
        self.n_items = int(n_items)
        self.n_partitions = int(n_partitions)
        self.grid_dims = tuple(grid_dims) if grid_dims is not None else None
        self.bucket = int(bucket)
        self.smoothing = float(smoothing)
        self.rebalance_every = int(rebalance_every)
        self.neighbors: Optional[np.ndarray] = None

        self._factors = np.ones(self.n_partitions)
        self._observed: Optional[np.ndarray] = None
        self._obs_counts: Optional[np.ndarray] = None
        self._n_obs = 0
        self._step = 0
        self.round = 0
        self.partition: Optional[NestedPartition] = None
        self.offsets: Optional[np.ndarray] = None
        self._resplice_hooks: List[Callable[[], None]] = []

        self.weights = np.full(self.n_partitions, 1.0 / self.n_partitions)
        self.counts = bucket_counts(np.diff(splice(self.n_items, self.weights)), self.bucket)
        self._resplice()

    @property
    def chunk_pads(self) -> tuple:
        """Padded chunk sizes per partition."""
        return tuple(pad_to_bucket(int(c), self.bucket) for c in self.counts)

    def rates(self) -> np.ndarray:
        """Items/s per partition under the last observation (uniform before
        any)."""
        if self._observed is None:
            return np.ones(self.n_partitions)
        with np.errstate(divide="ignore", invalid="ignore"):
            r = self._obs_counts / self._observed
        good = np.isfinite(r) & (r > 0)
        if not good.any():
            return np.ones(self.n_partitions)
        return np.where(good, r, r[good].mean())

    def predicted_makespan(self) -> float:
        """max_p counts_p / rate_p under the current belief."""
        with np.errstate(divide="ignore", invalid="ignore"):
            t = self.counts / self.rates()
        return float(np.nanmax(np.where(self.counts > 0, t, 0.0)))

    def inject_straggler(self, partition: int, factor: float) -> None:
        """Multiply partition's observed times by ``factor`` (test hook)."""
        self._factors[partition] = float(factor)

    # -- calibration / measurement -----------------------------------------

    def observe(self, times: Sequence[float]) -> None:
        """Record measured per-partition step seconds (straggler factors are
        applied here — the single injection point)."""
        self._observed = np.asarray(times, dtype=np.float64) * self._factors
        self._n_obs += 1
        # throughput is against the counts these times were measured under
        self._obs_counts = self.counts.astype(np.float64)

    def observe_chunk(self, report: CalibrationReport, n_steps: int):
        """Record one observed chunk's per-partition step seconds and advance
        the rebalance schedule by its steps; returns the applied ``Plan``
        when the schedule fired, else ``None``."""
        self.observe(np.asarray(report.step_s))
        return self.advance(int(n_steps))

    # -- solve / resplice ---------------------------------------------------

    def solve(self, weights: Sequence[float]) -> Plan:
        """Weights -> bucketed counts."""
        w = np.asarray(weights, dtype=np.float64)
        if w.sum() <= 0:
            raise RuntimeError("no live partitions left to solve over")
        w = w / w.sum()
        counts = bucket_counts(np.diff(splice(self.n_items, w)), self.bucket)
        return Plan(weights=w, counts=counts, round=self.round)

    def set_neighbors(self, neighbors: np.ndarray) -> None:
        """Install the true mesh topology (e.g. a periodic brick's) and
        re-splice so boundary/halo sets match it."""
        self.neighbors = np.asarray(neighbors, dtype=np.int64)
        self._resplice()

    def _resplice(self) -> None:
        """Rebuild the nested partition (or the chunk offsets) for the
        current counts and run the hooks."""
        if self.grid_dims is not None:
            self.partition = build_nested_partition(
                self.grid_dims,
                self.n_partitions,
                node_weights=np.maximum(self.counts, 0) if self.counts.sum() else None,
                neighbors=self.neighbors,
            )
            self.offsets = self.partition.offsets
        else:
            self.offsets = splice(self.n_items, np.maximum(self.counts, 1e-9))
        for hook in self._resplice_hooks:
            hook()

    def apply(self, plan: Plan) -> None:
        self.weights = np.asarray(plan.weights, dtype=np.float64)
        self.counts = np.asarray(plan.counts, dtype=np.int64).copy()
        self._resplice()

    def rebalance(self) -> Plan:
        """Observed step times -> equalizer -> new bucketed split -> resplice."""
        if self._observed is None:
            raise RuntimeError("rebalance before any observation; run calibrate() first")
        w = rebalance_from_measurements(
            np.maximum(self._obs_counts, 0),
            np.maximum(self._observed, 1e-30),
            smoothing=self.smoothing,
            prev_weights=self.weights,
        )
        self.round += 1
        plan = dataclasses.replace(self.solve(w), round=self.round)
        self.apply(plan)
        return plan

    def plan_from_report(self, report: CalibrationReport) -> Plan:
        """Overlap-aware solve from a phase-resolved calibration: the
        per-partition ``t_p(k) = boundary + max(interior, transfer) +
        correction`` models (``report.time_models``) go to
        ``solve_multiway``; the plan counts a round and is applied."""
        fns = report.time_models(self.counts)
        res = solve_multiway(fns, self.n_items)
        w = np.maximum(np.asarray(res.counts, dtype=np.float64), 1e-9)
        self.round += 1
        plan = dataclasses.replace(self.solve(w / w.sum()), round=self.round)
        self.apply(plan)
        return plan

    def maybe_rebalance(self, step: Optional[int] = None) -> Optional[Plan]:
        """Rebalance every ``rebalance_every`` steps (``<= 0`` disables)."""
        step = self._step if step is None else step
        if self.rebalance_every <= 0 or self._observed is None or step == 0:
            return None
        if step % self.rebalance_every:
            return None
        return self.rebalance()

    def advance(self, n_steps: int = 1) -> Optional[Plan]:
        """Advance the step counter and rebalance if the schedule fires."""
        self._step += int(n_steps)
        return self.maybe_rebalance(self._step)


class BlockedDGEngine:
    """Executes a ``DGSolver`` rhs as per-partition element blocks with halo
    gathers, on the solver's device (see module docstring).

    Each block's index tables are padded to ``bucket`` multiples: pad rows of
    the extended block gather element 0, pad rows of the own block scatter
    to the dump row ``K`` of a fresh ``(K+1)``-row target that ``rhs``
    zeroes per evaluation, and ``out[:K]`` drops it."""

    def __init__(self, solver, executor: NestedPartitionExecutor):
        if executor.grid_dims is None or tuple(executor.grid_dims) != tuple(solver.mesh.grid):
            raise ValueError(
                f"executor grid {executor.grid_dims} != solver grid {solver.mesh.grid}"
            )
        self.solver = solver
        self.executor = executor
        self.device = solver.device
        self._blocks: list = []
        self._pipeline = None
        self.schedule = self._make_schedule()
        # boundary/halo sets must follow the SOLVER mesh's topology
        mesh_nbr = np.asarray(solver.mesh.neighbors, dtype=np.int64)
        current = executor.partition.neighbors if executor.partition is not None else executor.neighbors
        if current is None or not np.array_equal(current, mesh_nbr):
            executor.set_neighbors(mesh_nbr)
        else:
            executor.neighbors = mesh_nbr
        self.rebuild()
        executor._resplice_hooks.append(self.rebuild)

    # -- the five phase functions ------------------------------------------

    @staticmethod
    def _gather(q, idx):
        return q[idx]

    @staticmethod
    def _assemble(q, own_idx, q_halo):
        # own rows ++ exchanged halo: the extended block q[own ++ halo ++ pad]
        return torch.cat([q[own_idx], q_halo], dim=0)

    def _interior(self, q, own_idx, rho, lam, mu):
        s = self.solver
        return volume_rhs_impl(q[own_idx], s.D, s.metrics, rho, lam, mu,
                               kernel_impl=s.kernel_impl)

    def _boundary(self, qb, nbr_local, rho, lam, mu, cp, cs):
        s = self.solver
        return surface_rhs(qb, nbr_local, s.lift, rho, lam, mu, cp, cs,
                           kernel_impl=s.kernel_impl)

    @staticmethod
    def _fold(vol, sur):
        # rows past the block's own count are dump rows
        return vol + sur[: vol.shape[0]]

    def _make_schedule(self) -> StepSchedule:
        def boundary(state):
            _, b = state
            return b["halo"]

        def exchange(send, state):
            q, _ = state
            return self._gather(q, send)

        def interior(state):
            q, b = state
            return self._interior(q, b["own_pad"], b["rho_o"], b["lam_o"], b["mu_o"])

        def correction(part, recv, state):
            q, b = state
            qb = self._assemble(q, b["own"], recv)
            sur = self._boundary(qb, b["nbr_local"], b["rho"], b["lam"],
                                 b["mu"], b["cp"], b["cs"])
            return self._fold(part, sur)

        return StepSchedule(boundary=boundary, exchange=exchange,
                            interior=interior, correction=correction)

    # -- block tables -------------------------------------------------------

    def rebuild(self) -> None:
        """Rebuild per-partition index and material tables (int64 and the
        solver's dtype, on its device) from the executor's partition."""
        s = self.solver
        part = self.executor.partition
        K = s.mesh.K
        nbr = np.asarray(s.mesh.neighbors, dtype=np.int64)
        bucket = self.executor.bucket
        dt, dev = s.tdtype, self.device
        # wave speeds from numpy on the host, as the reference engine builds
        # them (the flat solver computes its own on the device)
        cp_all = np.sqrt((s.lam + 2 * s.mu) / s.rho)
        cs_all = np.sqrt(s.mu / s.rho)
        idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
        val = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
        blocks = []
        for node in part.nodes:
            own = np.asarray(node.elements, dtype=np.int64)
            if len(own) == 0:
                blocks.append(None)
                continue
            halo = np.asarray(node.halo, dtype=np.int64)
            ext = np.concatenate([own, halo])
            pad = pad_to_bucket(len(ext), bucket)
            pad_own = pad_to_bucket(len(own), bucket)
            ext_pad = np.concatenate([ext, np.zeros(pad - len(ext), dtype=np.int64)])
            own_pad = np.concatenate([own, np.zeros(pad_own - len(own), dtype=np.int64)])
            halo_pad = ext_pad[len(own):]
            lut = np.full(K, -1, dtype=np.int64)
            lut[ext] = np.arange(len(ext))
            nbr_ext = nbr[ext_pad]
            # own rows resolve every real neighbour inside ext; -1 (physical
            # boundary) is kept; halo and pad rows may point outside ext ->
            # -1, and their output is dropped
            nbr_local = np.where(nbr_ext >= 0, lut[np.clip(nbr_ext, 0, None)], -1)
            scat = np.concatenate([own, np.full(pad_own - len(own), K, dtype=np.int64)])
            blocks.append(
                {
                    "own": idx(own),
                    "own_pad": idx(own_pad),
                    "halo": idx(halo_pad),
                    "nbr_local": idx(nbr_local),
                    "scat": idx(scat),
                    "rho": val(s.rho[ext_pad]),
                    "lam": val(s.lam[ext_pad]),
                    "mu": val(s.mu[ext_pad]),
                    "cp": val(cp_all[ext_pad]),
                    "cs": val(cs_all[ext_pad]),
                    "rho_o": val(s.rho[own_pad]),
                    "lam_o": val(s.lam[own_pad]),
                    "mu_o": val(s.mu[own_pad]),
                    "n_own": len(own),
                }
            )
        self._blocks = blocks

    # -- execution ----------------------------------------------------------

    def block_rhs(self, q, b):
        """One partition's rhs rows via the four-phase schedule."""
        return self.schedule.rhs((q, b))

    def scatter_target(self, q) -> torch.Tensor:
        """A zeroed (K+1)-row target; row K is the dump row for pad rows.
        Fresh per evaluation, so no rhs ever sees another's writes."""
        K = self.solver.mesh.K
        return torch.zeros((K + 1,) + tuple(q.shape[1:]), dtype=q.dtype, device=q.device)

    def rhs(self, q):
        """Full rhs assembled from per-partition blocks, composed phase-major
        (``StepSchedule.rhs_many``)."""
        K = self.solver.mesh.K
        blocks = [b for b in self._blocks if b is not None]
        outs = self.schedule.rhs_many([(q, b) for b in blocks])
        out = self.scatter_target(q)
        for b, r in zip(blocks, outs):
            out[b["scat"]] = r
        return out[:K]

    def pipeline(self):
        """The envelope-layout step pipeline bound to this engine (built
        once; its tables are rebuilt after every resplice)."""
        if self._pipeline is None:
            self._pipeline = FusedStepPipeline(self)
        return self._pipeline

    def resplice(self, plan) -> None:
        """Apply a solved plan (the resplice hooks rebuild the tables)."""
        self.executor.apply(plan)

    def run(self, q, n_steps: int, dt: Optional[float] = None, observe: bool = False,
            fused: bool = True):
        """LSRK4(5) on the blocked rhs; the caller's ``q`` is left intact.

        ``fused`` (default) drives the ``FusedStepPipeline`` (one volume and
        one surface launch per rhs).  With ``observe`` the run is cut into
        chunks on the executor's rebalance schedule; each chunk is one
        ``run_observed`` whose report feeds ``executor.observe_chunk``.
        ``fused=False`` is the per-block reference path; with ``observe`` it
        wall-times each step and attributes it by the current counts."""
        dt = dt or self.solver.cfl_dt()
        if fused and not observe:
            return self.pipeline().run(q, n_steps, dt=dt)
        if fused:
            done = 0
            while done < n_steps:
                chunk = n_steps - done
                if self.executor.rebalance_every > 0:
                    chunk = min(self.executor.rebalance_every, chunk)
                q, report = self.pipeline().run_observed(q, chunk, dt=dt)
                self.executor.observe_chunk(report, chunk)
                done += chunk
            return q
        q = q.clone()
        res = torch.zeros_like(q)
        shares = np.maximum(self.executor.counts.astype(np.float64), 0.0)
        for _ in range(n_steps):
            if observe:
                synchronize(self.device)
                t0 = time.perf_counter()
                q, res = lsrk45_step(q, res, self.rhs, dt)
                synchronize(self.device)
                report = CalibrationReport.from_chunk(time.perf_counter() - t0, shares, 1)
                self.executor.observe_chunk(report, 1)
                shares = np.maximum(self.executor.counts.astype(np.float64), 0.0)
            else:
                q, res = lsrk45_step(q, res, self.rhs, dt)
        return q

    # -- measurement --------------------------------------------------------

    def _time(self, fn, *args, reps: int = 1):
        """(median seconds, last result) of ``fn(*args)`` after one warmup."""
        out = fn(*args)
        synchronize(self.device)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn(*args)
            synchronize(self.device)
            ts.append(time.perf_counter() - t0)
        ts.sort()
        return ts[len(ts) // 2], out

    def measure_block_times(self, q, reps: int = 1) -> np.ndarray:
        """Per-partition seconds for one rhs evaluation of each block."""
        out = np.zeros(len(self._blocks))
        for p, b in enumerate(self._blocks):
            if b is None:
                continue
            out[p], _ = self._time(self.block_rhs, q, b, reps=reps)
        return out

    def calibrate(self, q, reps: int = 2) -> CalibrationReport:
        """Time the four schedule phases per partition — boundary (face
        flux), interior (volume), transfer (halo gather), correction
        (assemble + fold) — and observe the step totals."""
        P = len(self._blocks)
        boundary = np.zeros(P)
        interior = np.zeros(P)
        transfer = np.zeros(P)
        correction = np.zeros(P)
        for p, b in enumerate(self._blocks):
            if b is None:
                continue
            transfer[p], q_halo = self._time(self._gather, q, b["halo"], reps=reps)
            interior[p], vol = self._time(
                self._interior, q, b["own_pad"], b["rho_o"], b["lam_o"], b["mu_o"], reps=reps)
            t_asm, qb = self._time(self._assemble, q, b["own"], q_halo, reps=reps)
            boundary[p], sur = self._time(
                self._boundary, qb, b["nbr_local"], b["rho"], b["lam"], b["mu"],
                b["cp"], b["cs"], reps=reps)
            t_fold, _ = self._time(self._fold, vol, sur, reps=reps)
            correction[p] = t_asm + t_fold
        report = CalibrationReport(boundary_s=boundary, interior_s=interior,
                                   transfer_s=transfer, correction_s=correction)
        self.executor.observe(report.step_s)
        return report
