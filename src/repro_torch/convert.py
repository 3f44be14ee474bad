"""Carries state across from the JAX package as numpy arrays.

Every function here takes the JAX package's objects by duck typing and reads
them through ``np.asarray``, so this module imports neither ``jax`` nor
``repro``.  The field layout (K, 9, M, M, M), the field order (strain xx..xy,
then v) and the face order (-x, +x, -y, +y, -z, +z) are shared, so nothing is
permuted:

* ``solver_from`` — a mesh (grid, extent, neighbours incl. periodic wraps),
  materials (rho, lam, mu), order and dtype become the port's ``DGSolver``;
* ``field_from`` — a field ``q`` becomes a tensor on a given device;
* ``plan_from`` — an executor's ``weights``/``counts`` become a ``Plan`` the
  port's ``NestedPartitionExecutor.apply`` takes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dg.mesh import BrickMesh
from repro_torch.dg.solver import DGSolver, torch_dtype
from repro_torch.runtime.executor import Plan


def mesh_from(mesh) -> BrickMesh:
    """A port ``BrickMesh`` from any object with the reference mesh's fields
    (``grid``, ``extent``, ``neighbors``, ``centers``, ``h``)."""
    return BrickMesh(
        grid=tuple(int(g) for g in mesh.grid),
        extent=tuple(float(e) for e in mesh.extent),
        neighbors=np.array(mesh.neighbors, dtype=np.int64),
        centers=np.array(mesh.centers, dtype=np.float64),
        h=tuple(float(x) for x in mesh.h),
    )


def solver_from(solver, kernel_impl: str = "auto", device: DeviceLike = None) -> DGSolver:
    """The port's ``DGSolver`` for a reference solver's mesh, materials,
    order and dtype."""
    return DGSolver(
        mesh=mesh_from(solver.mesh),
        order=int(solver.order),
        rho=np.array(solver.rho, dtype=np.float64),
        lam=np.array(solver.lam, dtype=np.float64),
        mu=np.array(solver.mu, dtype=np.float64),
        dtype=str(solver.dtype),
        kernel_impl=kernel_impl,
        device=device,
    )


def field_from(q, device: DeviceLike = None, dtype=None) -> torch.Tensor:
    """A field (any array ``np.asarray`` reads) as a tensor on ``device``
    (``None`` means ``cuda``), in ``dtype`` or its own."""
    a = np.asarray(q)
    dt = torch_dtype(dtype) if dtype is not None else None
    return torch.as_tensor(np.array(a), dtype=dt, device=resolve_device(device))


def plan_from(executor) -> Plan:
    """A ``Plan`` carrying a reference executor's current ``weights`` and
    ``counts`` (and its ``round``)."""
    w = np.asarray(executor.weights, dtype=np.float64)
    counts = np.asarray(executor.counts, dtype=np.int64).copy()
    return Plan(weights=w / w.sum(), counts=counts, round=int(getattr(executor, "round", 0)))
