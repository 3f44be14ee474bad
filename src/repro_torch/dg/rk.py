"""Low-storage RK4(5) (Carpenter & Kennedy) — the paper's rk kernel.

``lsrk45_step`` mirrors the eager stage loop of the JAX package,

    res = A[s] * res + dt * rhs(q);   q = q + B[s] * res

with Python-float coefficients and the same operation order, but updates
``q`` and ``res`` IN PLACE to keep one field of memory per register (a
full-width float64 field is 302 MB).  Callers that still need their input
pass a copy.
"""

from __future__ import annotations

import numpy as np
import torch

LSRK_A = np.array([
    0.0,
    -567301805773.0 / 1357537059087.0,
    -2404267990393.0 / 2016746695238.0,
    -3550918686646.0 / 2091501179385.0,
    -1275806237668.0 / 842570457699.0,
])
LSRK_B = np.array([
    1432997174477.0 / 9575080441755.0,
    5161836677717.0 / 13612068292357.0,
    1720146321549.0 / 2090206949498.0,
    3134564353537.0 / 4481467310338.0,
    2277821191437.0 / 14882151754819.0,
])


def lsrk45_step(q: torch.Tensor, res: torch.Tensor, rhs_fn, dt: float):
    """One LSRK4(5) step; ``q`` and ``res`` (the low-storage register, same
    shape as q) are updated in place and returned."""
    dt = float(dt)
    for s in range(5):
        res.mul_(float(LSRK_A[s])).add_(dt * rhs_fn(q))
        q.add_(float(LSRK_B[s]) * res)
    return q, res
