"""Legendre-Gauss-Lobatto nodes, quadrature weights, differentiation matrix
(numpy, float64).

The collocation DGSEM uses the same LGL points for interpolation and
quadrature, so face values are plain slices of the volume tensor.
"""

from __future__ import annotations

import numpy as np


def _legendre_and_deriv(N: int, x: np.ndarray):
    """P_N(x) and P'_N(x) via the three-term recurrence."""
    p0 = np.ones_like(x)
    p1 = x.copy()
    if N == 0:
        return p0, np.zeros_like(x)
    for k in range(2, N + 1):
        p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
    dp = N * (x * p1 - p0) / (x**2 - 1.0 + 1e-300)
    return p1, dp


def lgl_nodes_weights(N: int):
    """LGL nodes (roots of (1-x^2) P'_N) and weights, float64."""
    if N < 1:
        raise ValueError("order must be >= 1")
    # Chebyshev-Gauss-Lobatto initial guess, Newton on q(x) = P'_N(x)
    x = -np.cos(np.pi * np.arange(N + 1) / N)
    for _ in range(100):
        pN, dpN = _legendre_and_deriv(N, x)
        # second derivative from Legendre's ODE
        d2p = (2 * x * dpN - N * (N + 1) * pN) / (1 - x**2 + 1e-300)
        dx = np.where(np.abs(1 - x**2) < 1e-14, 0.0, dpN / (d2p + 1e-300))
        x = x - dx
        if np.max(np.abs(dx)) < 1e-15:
            break
    x[0], x[-1] = -1.0, 1.0
    pN, _ = _legendre_and_deriv(N, x)
    w = 2.0 / (N * (N + 1) * pN**2)
    return x, w


def barycentric_weights(x: np.ndarray) -> np.ndarray:
    n = len(x)
    w = np.ones(n)
    for j in range(n):
        for k in range(n):
            if k != j:
                w[j] /= x[j] - x[k]
    return w


def diff_matrix(x: np.ndarray) -> np.ndarray:
    """Lagrange differentiation matrix at nodes x."""
    n = len(x)
    wb = barycentric_weights(x)
    D = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                D[i, j] = wb[j] / (wb[i] * (x[i] - x[j]))
        D[i, i] = -np.sum(D[i, [j for j in range(n) if j != i]])
    return D
