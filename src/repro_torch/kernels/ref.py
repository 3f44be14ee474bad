"""Plain PyTorch versions of the hand-written kernels.

They are the ``"torch"`` side of the kernel switch, what the wrappers use on
CPU tensors, and what ``chip_smoke.py`` and the CUDA tests hold the kernels
against on the card.  The DG ones repeat the arithmetic of
``dg.operators`` (the oracle the JAX package holds its Pallas kernels to);
``flash_attention_ref`` computes the function of the Pallas flash kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


MASKED = -1e30  # the Pallas flash kernel's NEG_INF: masked scores, not -inf


def flash_attention_ref(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D), Hq % Hkv == 0
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """The Pallas flash kernel's function (``kernels/flash_attention.py``
    of the JAX package): q.k^T and p.v in float32 from inputs cast to
    float32, masked scores set to -1e30, output ``acc / max(l, 1e-30)`` cast
    to the input dtype.  GQA is taken natively: q head ``h`` reads kv head
    ``h // (Hq / Hkv)``, the kernel's function on repeated k and v.  Query
    ``i`` sits at position ``q_offset + i``."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq {Hq} not a multiple of Hkv {Hkv}")
    g = Hq // Hkv
    scale = scale or 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, g * Sq, D)
    s = torch.matmul(qf, k.float().transpose(-1, -2)) * scale  # (B, Hkv, g*Sq, Skv)
    s = s.view(B, Hkv, g, Sq, Skv)
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, MASKED)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.view(B, Hkv, g * Sq, Skv), v.float()).view(B, Hkv, g, Sq, D)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, Sq, D).to(q.dtype)
