"""Structured hexahedral brick mesh (numpy) and the two-material geometry of
the paper's Fig 6.1 (acoustic | elastic halves)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.partition import face_neighbors

@dataclasses.dataclass(frozen=True)
class BrickMesh:
    grid: Tuple[int, int, int]
    extent: Tuple[float, float, float]
    neighbors: np.ndarray  # (K, 6) element id or -1
    centers: np.ndarray  # (K, 3)
    h: Tuple[float, float, float]  # element size per axis

    @property
    def K(self) -> int:
        return int(np.prod(self.grid))

    @property
    def jacobian(self) -> float:
        hx, hy, hz = self.h
        return hx * hy * hz / 8.0

    def metric(self, axis: int) -> float:
        """dr_axis/dx_axis for the affine map: 2/h."""
        return 2.0 / self.h[axis]


def make_brick(grid=(8, 8, 8), extent=(1.0, 1.0, 1.0), periodic: bool = False) -> BrickMesh:
    nx, ny, nz = grid
    hx, hy, hz = extent[0] / nx, extent[1] / ny, extent[2] / nz
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    eid = (ix + nx * (iy + ny * iz)).ravel()
    centers = np.zeros((nx * ny * nz, 3))
    centers[eid, 0] = (ix.ravel() + 0.5) * hx
    centers[eid, 1] = (iy.ravel() + 0.5) * hy
    centers[eid, 2] = (iz.ravel() + 0.5) * hz
    nbr = face_neighbors(grid)
    if periodic:

        def _id(jx, jy, jz):
            return jx + nx * (jy + ny * jz)

        fx, fy, fz = ix.ravel(), iy.ravel(), iz.ravel()
        wrap = [
            _id((fx - 1) % nx, fy, fz), _id((fx + 1) % nx, fy, fz),
            _id(fx, (fy - 1) % ny, fz), _id(fx, (fy + 1) % ny, fz),
            _id(fx, fy, (fz - 1) % nz), _id(fx, fy, (fz + 1) % nz),
        ]
        for f in range(6):
            m = nbr[eid, f] < 0
            nbr[eid[m], f] = wrap[f][m]
    return BrickMesh(grid=grid, extent=extent, neighbors=nbr, centers=centers, h=(hx, hy, hz))


def two_tree_materials(mesh: BrickMesh, cp=(1.0, 3.0), cs=(0.0, 2.0), rho=(1.0, 1.0)):
    """Fig 6.1: first half acoustic (cp=1, cs=0), second half elastic
    (cp=3, cs=2), discontinuity at the x midplane.  Returns per-element
    (rho, lam, mu, region)."""
    half = mesh.centers[:, 0] >= mesh.extent[0] / 2.0
    region = half.astype(np.int64)
    rho_e = np.asarray(rho)[region]
    cp_e = np.asarray(cp)[region]
    cs_e = np.asarray(cs)[region]
    mu = rho_e * cs_e**2
    lam = rho_e * (cp_e**2 - 2 * cs_e**2)
    return rho_e, lam, mu, region
