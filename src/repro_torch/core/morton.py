"""Morton (Z-order) space-filling-curve ordering (numpy).

The level-1 partition Morton-orders the brick's elements and splices the
1-D array into contiguous chunks, which keeps each partition's surface, and
so its face traffic, near-minimal.  Supports non-power-of-two, anisotropic
grids by interleaving enough bits per axis.
"""

from __future__ import annotations

import numpy as np

__all__ = ["interleave_bits3", "morton_encode3", "morton_order", "curve_rank"]


def _part1by2(x: np.ndarray, nbits: int) -> np.ndarray:
    """Spread the low ``nbits`` bits of x so consecutive bits are 3 apart."""
    x = x.astype(np.uint64)
    out = np.zeros_like(x)
    for b in range(nbits):
        out |= ((x >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b)
    return out


def interleave_bits3(ix: np.ndarray, iy: np.ndarray, iz: np.ndarray, nbits: int) -> np.ndarray:
    """Interleave bits of three integer coordinate arrays (x lowest)."""
    return (
        _part1by2(ix, nbits)
        | (_part1by2(iy, nbits) << np.uint64(1))
        | (_part1by2(iz, nbits) << np.uint64(2))
    )


def morton_encode3(coords: np.ndarray) -> np.ndarray:
    """Morton codes for integer coordinates of shape (K, 3)."""
    coords = np.asarray(coords)
    if coords.ndim != 2 or coords.shape[1] != 3:
        raise ValueError(f"expected (K, 3) integer coords, got {coords.shape}")
    if coords.size and coords.min() < 0:
        raise ValueError("coordinates must be non-negative")
    maxc = int(coords.max()) if coords.size else 0
    nbits = max(1, int(maxc).bit_length())
    if 3 * nbits > 63:
        raise ValueError(f"grid too large for 64-bit Morton codes: max coord {maxc}")
    return interleave_bits3(coords[:, 0], coords[:, 1], coords[:, 2], nbits)


def morton_order(grid_dims: tuple) -> np.ndarray:
    """Permutation of element ids (x-fastest raveling) into Morton order.

    ``grid_dims = (nx, ny, nz)``; element id ``e = ix + nx*(iy + ny*iz)``.
    Returns ``perm`` such that ``elements[perm]`` is Morton-ordered.
    """
    nx, ny, nz = grid_dims
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    eid = (ix + nx * (iy + ny * iz)).ravel()
    codes = morton_encode3(np.stack([ix.ravel(), iy.ravel(), iz.ravel()], axis=1))
    order = np.argsort(codes, kind="stable")
    return eid[order]


def curve_rank(order: np.ndarray) -> np.ndarray:
    """Inverse permutation: ``rank[e]`` is where element ``e`` sits in
    ``order``."""
    order = np.asarray(order)
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order), dtype=np.int64)
    return rank
