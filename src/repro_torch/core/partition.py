"""The nested, two-level, asymmetric partition (numpy).

Level 1: Morton-order the elements and splice the curve into contiguous
chunks, one per partition, sized by the partition weights.  Level 2: split
each chunk into ``boundary`` elements (a face neighbour on another
partition) and ``interior`` elements, of which a Morton-contiguous block may
go to an accelerator.  Everything is numpy on element indices; the torch
engines consume the index arrays.  The partition is a reordering, never an
approximation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.morton import morton_order

__all__ = [
    "splice",
    "face_neighbors",
    "surface_faces",
    "NodePartition",
    "NestedPartition",
    "build_nested_partition",
]


def splice(n_items: int, weights: Optional[Sequence[float]] = None, n_parts: Optional[int] = None) -> np.ndarray:
    """Contiguous splice of ``n_items`` into parts proportional to ``weights``.

    Returns offsets of shape (P+1,).  Largest-remainder rounding so that
    sizes sum exactly to ``n_items`` and no part is negative.
    """
    if weights is None:
        if n_parts is None:
            raise ValueError("need weights or n_parts")
        weights = np.ones(n_parts)
    w = np.asarray(weights, dtype=np.float64)
    if (w < 0).any() or w.sum() <= 0:
        raise ValueError(f"invalid weights {w}")
    ideal = n_items * w / w.sum()
    base = np.floor(ideal).astype(np.int64)
    rem = n_items - base.sum()
    frac = ideal - base
    order = np.argsort(-frac, kind="stable")
    base[order[:rem]] += 1
    offsets = np.zeros(len(w) + 1, dtype=np.int64)
    np.cumsum(base, out=offsets[1:])
    if offsets[-1] != n_items:
        raise AssertionError(f"splice lost items: {offsets[-1]} != {n_items}")
    return offsets


def face_neighbors(grid_dims: tuple) -> np.ndarray:
    """Face-neighbour ids for a structured hex grid.

    Returns (K, 6) int64, entries -1 at physical boundaries.
    Face order: (-x, +x, -y, +y, -z, +z).  Element id is x-fastest.
    """
    nx, ny, nz = grid_dims
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    eid = ix + nx * (iy + ny * iz)
    K = nx * ny * nz
    nbr = np.full((K, 6), -1, dtype=np.int64)

    def _id(jx, jy, jz):
        return jx + nx * (jy + ny * jz)

    m = ix > 0
    nbr[eid[m], 0] = _id(ix[m] - 1, iy[m], iz[m])
    m = ix < nx - 1
    nbr[eid[m], 1] = _id(ix[m] + 1, iy[m], iz[m])
    m = iy > 0
    nbr[eid[m], 2] = _id(ix[m], iy[m] - 1, iz[m])
    m = iy < ny - 1
    nbr[eid[m], 3] = _id(ix[m], iy[m] + 1, iz[m])
    m = iz > 0
    nbr[eid[m], 4] = _id(ix[m], iy[m], iz[m] - 1)
    m = iz < nz - 1
    nbr[eid[m], 5] = _id(ix[m], iy[m], iz[m] + 1)
    return nbr


def surface_faces(mask: np.ndarray, neighbors: np.ndarray) -> int:
    """Number of faces between elements inside ``mask`` and other elements
    (the physical boundary excluded)."""
    inside = mask[:, None]
    valid = neighbors >= 0
    nbr_in = np.zeros_like(valid)
    nbr_in[valid] = mask[neighbors[valid]]
    cut = inside & valid & (~nbr_in)
    return int(cut[mask].sum())


@dataclasses.dataclass(frozen=True)
class NodePartition:
    """Level-2 split of one partition's Morton-contiguous element chunk:
    ``boundary`` and ``interior`` (= ``host_interior`` + ``accel``) are a
    disjoint cover of ``elements``; ``halo`` holds the remote elements whose
    faces touch the chunk (what the exchange phase fetches)."""

    node: int
    elements: np.ndarray
    boundary: np.ndarray
    host_interior: np.ndarray
    accel: np.ndarray
    halo: Optional[np.ndarray] = None

    @property
    def interior(self) -> np.ndarray:
        return np.concatenate([self.host_interior, self.accel])

    @property
    def n_elements(self) -> int:
        return len(self.elements)


@dataclasses.dataclass(frozen=True)
class NestedPartition:
    grid_dims: tuple
    n_nodes: int
    order: np.ndarray  # (K,) Morton permutation of global element ids
    offsets: np.ndarray  # (n_nodes+1,) splice points into ``order``
    node_of: np.ndarray  # (K,) partition id per global element id
    boundary_mask: np.ndarray  # (K,) bool per global element id
    accel_mask: np.ndarray  # (K,) bool per global element id
    nodes: tuple  # tuple[NodePartition, ...]
    neighbors: Optional[np.ndarray] = None  # (K, 6) topology the split used

    @property
    def n_elements(self) -> int:
        return len(self.order)

    def validate(self) -> None:
        """Raise ``AssertionError`` unless the split is a disjoint cover with
        consistent boundary/interior/halo sets."""
        K = self.n_elements
        if sorted(self.order.tolist()) != list(range(K)):
            raise AssertionError("order must be a permutation")
        counts = np.zeros(K, dtype=np.int64)
        neighbors = self.neighbors if self.neighbors is not None else face_neighbors(self.grid_dims)
        for npart in self.nodes:
            counts[npart.elements] += 1
            merged = np.sort(np.concatenate([npart.boundary, npart.host_interior, npart.accel]))
            if not np.array_equal(merged, np.sort(npart.elements)):
                raise AssertionError("host/accel split must cover the chunk")
            if self.boundary_mask[npart.accel].any():
                raise AssertionError("accel may only own interior elements")
            if len(np.intersect1d(npart.boundary, npart.interior)):
                raise AssertionError("boundary and interior must be disjoint")
            if npart.halo is not None:
                nn = neighbors[npart.elements].ravel()
                nn = nn[nn >= 0]
                expected = np.unique(nn[self.node_of[nn] != npart.node])
                if not np.array_equal(np.sort(npart.halo), expected):
                    raise AssertionError("halo mismatch")
        if not (counts == 1).all():
            raise AssertionError("every element assigned to exactly one partition")


def _choose_accel_block(interior: np.ndarray, n_accel: int, neighbors: np.ndarray) -> tuple:
    """Pick a Morton-contiguous block of ``n_accel`` interior elements with
    (approximately) the fewest exposed faces among a few candidate windows."""
    n = len(interior)
    if n_accel <= 0:
        return interior[:0], interior
    if n_accel >= n:
        return interior, interior[:0]
    K = neighbors.shape[0]
    best = None
    best_cut = None
    starts = sorted({0, (n - n_accel) // 4, (n - n_accel) // 2, 3 * (n - n_accel) // 4, n - n_accel})
    for s in starts:
        sel = interior[s : s + n_accel]
        mask = np.zeros(K, dtype=bool)
        mask[sel] = True
        cut = surface_faces(mask, neighbors)
        if best_cut is None or cut < best_cut:
            best_cut, best = cut, s
    sel = interior[best : best + n_accel]
    rest = np.concatenate([interior[:best], interior[best + n_accel :]])
    return sel, rest


def build_nested_partition(
    grid_dims: tuple,
    n_nodes: int,
    accel_fraction: float = 0.0,
    node_weights: Optional[Sequence[float]] = None,
    accel_counts: Optional[Sequence[int]] = None,
    neighbors: Optional[np.ndarray] = None,
) -> NestedPartition:
    """Build the two-level partition for a structured hex grid.

    ``accel_fraction`` is the target share of each chunk to offload, clamped
    to the available interior; ``accel_counts`` overrides it per partition.
    ``neighbors`` is the (K, 6) face table to split on (pass the solver
    mesh's table for periodic bricks).
    """
    nx, ny, nz = grid_dims
    K = nx * ny * nz
    if K < n_nodes:
        raise ValueError(f"{K} elements < {n_nodes} nodes")
    order = morton_order(grid_dims)
    offsets = splice(K, node_weights, n_parts=n_nodes)
    node_of = np.empty(K, dtype=np.int64)
    for p in range(n_nodes):
        node_of[order[offsets[p] : offsets[p + 1]]] = p

    if neighbors is None:
        neighbors = face_neighbors(grid_dims)
    else:
        neighbors = np.asarray(neighbors, dtype=np.int64)
        if neighbors.shape != (K, 6):
            raise ValueError(f"neighbors shape {neighbors.shape} != {(K, 6)}")
    # boundary = a face neighbour on another partition (the physical
    # boundary does not make an element 'boundary')
    nbr_node = np.where(neighbors >= 0, node_of[np.clip(neighbors, 0, None)], -2)
    boundary_mask = ((nbr_node >= 0) & (nbr_node != node_of[:, None])).any(axis=1)

    accel_mask = np.zeros(K, dtype=bool)
    nodes = []
    for p in range(n_nodes):
        chunk = order[offsets[p] : offsets[p + 1]]
        is_b = boundary_mask[chunk]
        boundary = chunk[is_b]
        interior = chunk[~is_b]
        if accel_counts is not None:
            n_accel = int(accel_counts[p])
        else:
            n_accel = int(round(accel_fraction * len(chunk)))
        n_accel = max(0, min(n_accel, len(interior)))
        accel, host_interior = _choose_accel_block(interior, n_accel, neighbors)
        accel_mask[accel] = True
        nn = neighbors[chunk].ravel()
        nn = nn[nn >= 0]
        halo = np.unique(nn[node_of[nn] != p])
        nodes.append(
            NodePartition(
                node=p,
                elements=chunk,
                boundary=boundary,
                host_interior=host_interior,
                accel=accel,
                halo=halo,
            )
        )

    return NestedPartition(
        grid_dims=grid_dims,
        n_nodes=n_nodes,
        order=order,
        offsets=offsets,
        node_of=node_of,
        boundary_mask=boundary_mask,
        accel_mask=accel_mask,
        nodes=tuple(nodes),
        neighbors=neighbors,
    )
