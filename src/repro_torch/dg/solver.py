"""Assembled DGSEM solver on a brick mesh (flat, single-array execution) in
PyTorch.

``DGSolver`` runs on ``device`` (``None`` means ``cuda``, which raises
without a card).  ``kernel_impl`` selects the volume and flux bodies
(``kernels/ops.py``): ``"auto"`` launches the CUDA kernels on the card and
the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.dg.basis import diff_matrix, lgl_nodes_weights
from repro_torch.dg.mesh import BrickMesh, make_brick, two_tree_materials
from repro_torch.dg.operators import dg_rhs, stress
from repro_torch.dg.rk import lsrk45_step
from repro_torch.kernels.ops import IMPLS


def torch_dtype(name) -> torch.dtype:
    """"float32"/"float64" (or a torch dtype) as a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return {"float32": torch.float32, "float64": torch.float64}[str(name)]


@dataclasses.dataclass
class DGSolver:
    mesh: BrickMesh
    order: int
    rho: np.ndarray
    lam: np.ndarray
    mu: np.ndarray
    dtype: str = "float64"
    kernel_impl: str = "auto"  # auto | torch | cuda
    device: DeviceLike = None

    def __post_init__(self):
        if self.kernel_impl not in IMPLS:
            raise ValueError(f"kernel_impl must be one of {IMPLS}, got {self.kernel_impl!r}")
        self.device = resolve_device(self.device)
        x, w = lgl_nodes_weights(self.order)
        self.nodes, self.weights = x, w
        dt = torch_dtype(self.dtype)
        self.tdtype = dt
        dev = self.device
        self.D = torch.as_tensor(diff_matrix(x), dtype=dt, device=dev)
        self.metrics = tuple(self.mesh.metric(a) for a in range(3))
        self.lift = tuple(self.mesh.metric(a) / w[0] for a in range(3))
        self.neighbors = torch.as_tensor(np.asarray(self.mesh.neighbors, dtype=np.int64), device=dev)
        self.rho_t = torch.as_tensor(self.rho, dtype=dt, device=dev)
        self.lam_t = torch.as_tensor(self.lam, dtype=dt, device=dev)
        self.mu_t = torch.as_tensor(self.mu, dtype=dt, device=dev)
        # wave speeds on the device, as the reference solver computes them
        self.cp_t = torch.sqrt((self.lam_t + 2 * self.mu_t) / self.rho_t)
        self.cs_t = torch.sqrt(self.mu_t / self.rho_t)

    @property
    def M(self) -> int:
        return self.order + 1

    # ------------------------------------------------------------------
    def node_coords(self) -> np.ndarray:
        """Physical coordinates of all nodes: (K, M, M, M, 3), numpy."""
        K = self.mesh.K
        M = self.M
        r = (self.nodes + 1) / 2
        h = self.mesh.h
        c = self.mesh.centers
        out = np.zeros((K, M, M, M, 3))
        for a in range(3):
            shape = [1, 1, 1]
            shape[a] = M
            coord = c[:, a][:, None, None, None] + (r.reshape(shape) - 0.5) * h[a]
            out[..., a] = np.broadcast_to(coord, (K, M, M, M))
        return out

    def zero_state(self) -> torch.Tensor:
        return torch.zeros((self.mesh.K, 9, self.M, self.M, self.M),
                           dtype=self.tdtype, device=self.device)

    def rhs(self, q: torch.Tensor) -> torch.Tensor:
        return dg_rhs(
            q, self.D, self.metrics, self.lift, self.neighbors,
            self.rho_t, self.lam_t, self.mu_t, self.cp_t, self.cs_t,
            kernel_impl=self.kernel_impl,
        )

    def cfl_dt(self, cfl: float = 0.3) -> float:
        cp_max = float(np.sqrt((self.lam + 2 * self.mu) / self.rho).max())
        h_min = min(self.mesh.h)
        return cfl * h_min / (cp_max * self.order**2)

    def run(self, q, n_steps: int, dt: Optional[float] = None, *,
            observe: bool = False, fused: bool = True):
        """Advance ``n_steps`` (the Engine protocol's driver); the caller's
        ``q`` is left intact.

        In this port both ``fused`` settings run the same eager Python loop
        over steps and stages (a CUDA-graph capture of the run is later
        work); ``observe`` is accepted for protocol compatibility and
        ignored — the flat solver has no partitions to attribute time to."""
        del observe, fused
        dt = dt or self.cfl_dt()
        q = q.clone()
        res = torch.zeros_like(q)
        for _ in range(n_steps):
            q, res = lsrk45_step(q, res, self.rhs, dt)
        return q

    def calibrate(self, q, reps: int = 2, dt: Optional[float] = None):
        """Whole-step wall seconds as a single-partition report
        (``CalibrationReport.from_totals``)."""
        from repro_torch.runtime.schedule import CalibrationReport

        dt = dt or self.cfl_dt()
        ts = []
        for i in range(max(1, reps) + 1):  # the first step warms up
            qq, res = q.clone(), torch.zeros_like(q)
            synchronize(self.device)
            t0 = time.perf_counter()
            lsrk45_step(qq, res, self.rhs, dt)
            synchronize(self.device)
            if i:
                ts.append(time.perf_counter() - t0)
        ts.sort()
        return CalibrationReport.from_totals([ts[len(ts) // 2]])

    def resplice(self, plan=None) -> None:
        """Engine-protocol no-op: a flat solver has a single partition."""
        del plan

    # ------------------------------------------------------------------
    def energy(self, q: torch.Tensor) -> float:
        """0.5 * int rho|v|^2 + E:C:E  (quadrature-weighted)."""
        w = self.weights
        W = torch.as_tensor(np.einsum("i,j,k->ijk", w, w, w), dtype=q.dtype,
                            device=q.device) * self.mesh.jacobian
        v = q[:, 6:9]
        kin = 0.5 * self.rho_t[:, None, None, None] * torch.sum(v**2, dim=1)
        S = stress(q, self.lam_t, self.mu_t)
        E = q[:, :6]
        es = (
            E[:, 0] * S[:, 0] + E[:, 1] * S[:, 1] + E[:, 2] * S[:, 2]
            + 2 * (E[:, 3] * S[:, 3] + E[:, 4] * S[:, 4] + E[:, 5] * S[:, 5])
        )
        pot = 0.5 * es
        return float(torch.sum((kin + pot) * W[None]))


def make_two_tree_solver(grid=(8, 4, 4), order: int = 3, extent=(2.0, 1.0, 1.0),
                         cp=(1.0, 3.0), cs=(0.0, 2.0), rho=(1.0, 1.0), dtype="float64",
                         kernel_impl="auto", device: DeviceLike = None) -> DGSolver:
    """The paper's Fig 6.1 setup (scaled down by default)."""
    mesh = make_brick(grid, extent)
    rho_e, lam, mu, _ = two_tree_materials(mesh, cp, cs, rho)
    return DGSolver(mesh=mesh, order=order, rho=rho_e, lam=lam, mu=mu, dtype=dtype,
                    kernel_impl=kernel_impl, device=device)


def gaussian_pulse(solver: DGSolver, center=(0.5, 0.5, 0.5), width: float = 0.08,
                   component: int = 6, device: DeviceLike = None) -> torch.Tensor:
    """A field with one v or E component set to a Gaussian, on ``device``
    (``None`` means ``cuda``)."""
    dev = resolve_device(device)
    xyz = solver.node_coords()
    r2 = sum((xyz[..., a] - center[a]) ** 2 for a in range(3))
    blob = np.exp(-r2 / (2 * width**2))
    q = np.zeros((solver.mesh.K, 9, solver.M, solver.M, solver.M))
    q[:, component] = blob
    return torch.as_tensor(q, dtype=solver.tdtype, device=dev)
