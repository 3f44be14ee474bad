"""Plain PyTorch versions of the hand-written kernels.

They are the ``"torch"`` side of the kernel switch, what the wrappers use on
CPU tensors, and what ``chip_smoke.py`` and the CUDA tests hold the kernels
against on the card.  Each repeats the arithmetic of ``dg.operators`` (the
oracle the JAX package holds its Pallas kernels to).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.dg.operators import riemann_correction, volume_rhs


def dg_volume_ref(
    q: torch.Tensor,  # (K, 9, M, M, M)
    D: torch.Tensor,
    metrics: Tuple[float, float, float],
    rho: torch.Tensor,
    lam: torch.Tensor,
    mu: torch.Tensor,
) -> torch.Tensor:
    return volume_rhs(q, D, metrics, rho, lam, mu)


def dg_volume_term_scale(q, D, metrics, rho, lam, mu) -> torch.Tensor:
    """For each output of ``dg_volume``, the sum of the magnitudes of the
    terms it adds up: the same contraction over ``|q|`` and ``|D|`` (the
    metrics and rho, lam, mu are non-negative, and every term enters with a
    plus sign).  Two roundings of the sum differ by a few ulps of this, not
    of the result, which cancellation can make small."""
    return volume_rhs(q.abs(), D.abs(), metrics, rho, lam, mu)


def dg_flux_ref(
    Sm: torch.Tensor,  # (F, 6, M, M)
    vm: torch.Tensor,  # (F, 3, M, M)
    Sp: torch.Tensor,
    vp: torch.Tensor,
    mats: torch.Tensor,  # (F, 8): rho-,cp-,cs-,mu-,rho+,cp+,cs+,mu+
    axis: int,
    sign: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    mat_m = {"rho": mats[:, 0], "cp": mats[:, 1], "cs": mats[:, 2], "mu": mats[:, 3]}
    mat_p = {"rho": mats[:, 4], "cp": mats[:, 5], "cs": mats[:, 6], "mu": mats[:, 7]}
    return riemann_correction(Sm, vm, Sp, vp, axis, sign, mat_m, mat_p)
