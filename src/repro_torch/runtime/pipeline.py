"""The blocked engine's time loop over the envelope layout, in PyTorch.

``FusedStepPipeline`` pads every block of a ``BlockedDGEngine`` to a common
envelope ``(env, env_own)`` = (largest padded extended block, largest padded
own block) and stacks them, so each rhs evaluation is exactly ONE volume
launch and ONE surface evaluation (one flux launch per face direction)
however ragged the split.  The padded tail is arithmetically inert:

* padded extended rows gather ``q[0]`` with unit materials and carry the
  neighbour sentinel -1; no real row references them, because every real
  row's neighbours resolve inside its own block, offset by ``i * env``;
* padded own rows gather ``q[0]`` with unit ``rho_o`` and scatter to the
  dump row ``K`` of a zeroed ``(K+1)``-row target, which ``out[:K]`` drops;
* real rows see exactly the operands of the per-block path, because both
  kernels work per element (volume) or per face (flux).

In this slice a run is an eager Python loop over steps and LSRK stages on
the envelope tables; capturing it in a CUDA graph is later work.  The
``DispatchStats`` ledger keeps the JAX meaning: one ``record`` per ``run``
call, and ``kernel_launches`` = ``{"volume": 1, "surface": 1}`` per rhs.

The pipeline registers itself as a resplice hook of the executor: a
rebalance drops the stacked tables and the next call rebuilds them.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import synchronize
from repro_torch.dg.operators import surface_rhs, volume_rhs_impl
from repro_torch.dg.rk import lsrk45_step
from repro_torch.runtime.schedule import CalibrationReport, DispatchStats

__all__ = ["FusedStepPipeline"]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class FusedStepPipeline:
    """One engine's time loop over the envelope tables."""

    def __init__(self, engine):
        self.engine = engine
        self.executor = engine.executor
        self.solver = engine.solver
        self.device = engine.device
        self._tables: Optional[Dict[str, torch.Tensor]] = None
        self._sig: Optional[tuple] = None
        self._launches: Dict[str, int] = {}
        self.stats = DispatchStats()
        self.executor._resplice_hooks.append(self.invalidate)

    @property
    def dispatches(self) -> int:
        return self.stats.dispatches

    @property
    def steps_run(self) -> int:
        return self.stats.steps_run

    # -- tables -------------------------------------------------------------

    def invalidate(self) -> None:
        """Resplice hook: drop the stacked tables."""
        self._tables = None
        self._sig = None

    def _build_tables(self) -> None:
        """Pad every block to the envelope and stack (see module docstring)."""
        blks = [b for b in self.engine._blocks if b is not None]
        if not blks:
            raise RuntimeError("the engine has no non-empty block to run")
        K = self.solver.mesh.K
        env = max(int(b["nbr_local"].shape[0]) for b in blks)
        env_own = max(int(b["own_pad"].shape[0]) for b in blks)

        def pad_rows(a: np.ndarray, n: int, fill) -> np.ndarray:
            if a.shape[0] < n:
                tail = np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
                a = np.concatenate([a, tail])
            return a

        ext = np.concatenate([
            pad_rows(np.concatenate([_host(b["own"]), _host(b["halo"])]), env, 0)
            for b in blks
        ])
        nbr = np.concatenate([
            pad_rows(np.where(nl >= 0, nl + i * env, nl), env, -1)
            for i, nl in enumerate(_host(b["nbr_local"]) for b in blks)
        ])
        own_pad = np.concatenate([pad_rows(_host(b["own_pad"]), env_own, 0) for b in blks])
        scat = np.concatenate([pad_rows(_host(b["scat"]), env_own, K) for b in blks])
        dev, dt = self.device, self.solver.tdtype
        idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
        tables = {"ext": idx(ext), "own_pad": idx(own_pad), "scat": idx(scat), "nbr": idx(nbr)}
        for key, n in (("rho", env), ("lam", env), ("mu", env), ("cp", env), ("cs", env),
                       ("rho_o", env_own), ("lam_o", env_own), ("mu_o", env_own)):
            col = np.concatenate([pad_rows(_host(b[key]), n, 1.0) for b in blks])
            tables[key] = torch.as_tensor(col, dtype=dt, device=dev)
        self._tables = tables
        self._sig = ((env, env_own, len(blks)),)

    def _ensure(self) -> None:
        if self._tables is None:
            self._build_tables()

    @property
    def bucket_signature(self) -> tuple:
        """((env, env_own, n_blocks),) — the envelope's shape."""
        self._ensure()
        return self._sig

    # -- the rhs ------------------------------------------------------------

    def _rhs(self, q: torch.Tensor) -> torch.Tensor:
        """One full-field rhs: one gather + one volume launch + one surface
        evaluation + one scatter."""
        s = self.solver
        T = self._tables
        (env, env_own, B), = self._sig
        K = s.mesh.K
        launches = {"volume": 0, "surface": 0}
        vol = volume_rhs_impl(q[T["own_pad"]], s.D, s.metrics,
                              T["rho_o"], T["lam_o"], T["mu_o"], kernel_impl=s.kernel_impl)
        launches["volume"] += 1
        sur = surface_rhs(q[T["ext"]], T["nbr"], s.lift, T["rho"], T["lam"], T["mu"],
                          T["cp"], T["cs"], kernel_impl=s.kernel_impl)
        launches["surface"] += 1
        # fold the leading env_own surface rows of every block into its volume
        sur_own = sur.reshape((B, env) + sur.shape[1:])[:, :env_own]
        sur_own = sur_own.reshape((B * env_own,) + sur.shape[1:])
        out = self.engine.scatter_target(q)
        out[T["scat"]] = vol + sur_own
        self._launches = launches
        return out[:K]

    # -- execution ----------------------------------------------------------

    def rhs(self, q):
        """One rhs evaluation over the envelope tables."""
        self._ensure()
        self.stats.record(1, 0)
        out = self._rhs(q)
        self.stats.record_launches(self._launches)
        return out

    def run(self, q, n_steps: int, dt: Optional[float] = None, price=None):
        """Advance ``n_steps``; the caller's ``q`` is copied, not consumed.

        With ``price`` (a per-partition per-step cost vector) the call also
        accumulates it once per step and returns ``(q, accumulated)``."""
        dt = dt if dt is not None else self.solver.cfl_dt()
        self._ensure()
        q = q.clone()
        res = torch.zeros_like(q)
        acc = None if price is None else np.zeros(len(price), dtype=np.float64)
        self.stats.record(1, int(n_steps))
        for _ in range(int(n_steps)):
            q, res = lsrk45_step(q, res, self._rhs, dt)
            if acc is not None:
                acc += np.asarray(price, dtype=np.float64)
        self.stats.record_launches(self._launches)
        return q if price is None else (q, acc)

    def run_observed(self, q, n_steps: int, dt: Optional[float] = None):
        """Advance ``n_steps`` as one run AND observe it: the chunk's wall
        seconds (the device synchronized at both ends) are attributed across
        partitions in proportion to the accumulated price, the executor's
        element counts (``CalibrationReport.from_chunk``).  Returns
        ``(q, report)``; straggler factors are applied later, by
        ``executor.observe``."""
        price = np.maximum(self.executor.counts.astype(np.float64), 0.0)
        synchronize(self.device)
        t0 = time.perf_counter()
        q, acc = self.run(q, n_steps, dt=dt, price=price)
        synchronize(self.device)
        wall = time.perf_counter() - t0
        self.stats.record_chunk()
        return q, CalibrationReport.from_chunk(wall, acc, n_steps)
