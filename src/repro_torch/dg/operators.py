"""DGSEM operators in PyTorch: volume derivatives, face extraction, the exact
Riemann flux and lift — the paper's volume_loop / interp_q / int_flux / lift.

Field layout (the JAX package's): q (K, 9, M, M, M) with fields
  0..5 = strain E (xx, yy, zz, yz, xz, xy)   [symmetric, 6 stored]
  6..8 = velocity v (x, y, z)
Element axes are (r1, r2, r3) = (x, y, z) on the affine brick; faces are
ordered (-x, +x, -y, +y, -z, +z).

Flux: with S_j = S^- - S^+, v_j = v^- - v^+ and n = s*e_a,
  k0 = 1/(rho^- cp^- + rho^+ cp^+),  k1 = 1/(rho^- cs^- + rho^+ cs^+)
  (k1 = 0 where mu^- = 0, the acoustic side).  Traction-free boundaries
  (neighbour -1) use the mirror [v] = 0, S_j = 2 S^-; cross-partition faces
  (neighbour -2) are skipped.

These functions are also the plain versions (``kernels/ref.py``) the CUDA
kernels are held against.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# strain component index for the (a, b) entry of the symmetric tensor
SYM = np.array([
    [0, 5, 4],
    [5, 1, 3],
    [4, 3, 2],
])
FACE_AXIS = (0, 0, 1, 1, 2, 2)
FACE_SIGN = (-1.0, 1.0, -1.0, 1.0, -1.0, 1.0)
OPPOSITE = (1, 0, 3, 2, 5, 4)


def deriv(u: torch.Tensor, D: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply the differentiation matrix along element axis (0,1,2) of
    u (K, F, M, M, M)."""
    if axis == 0:
        return torch.einsum("am,kfmjl->kfajl", D, u)
    if axis == 1:
        return torch.einsum("am,kfiml->kfial", D, u)
    return torch.einsum("am,kfijm->kfija", D, u)


def stress(q: torch.Tensor, lam: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """S (K, 6, M, M, M) from the strain fields of q; lam/mu (K,)."""
    E = q[:, :6]
    tr = E[:, 0] + E[:, 1] + E[:, 2]
    lam_ = lam[:, None, None, None]
    mu_ = mu[:, None, None, None]
    Sxx = lam_ * tr + 2 * mu_ * E[:, 0]
    Syy = lam_ * tr + 2 * mu_ * E[:, 1]
    Szz = lam_ * tr + 2 * mu_ * E[:, 2]
    Syz = 2 * mu_ * E[:, 3]
    Sxz = 2 * mu_ * E[:, 4]
    Sxy = 2 * mu_ * E[:, 5]
    return torch.stack([Sxx, Syy, Szz, Syz, Sxz, Sxy], dim=1)


def volume_rhs(
    q: torch.Tensor,  # (K, 9, M, M, M)
    D: torch.Tensor,
    metrics: Tuple[float, float, float],  # 2/h per axis
    rho: torch.Tensor,
    lam: torch.Tensor,
    mu: torch.Tensor,
) -> torch.Tensor:
    """The paper's volume_loop: dE/dt = sym(grad v); rho dv/dt = div S."""
    v = q[:, 6:9]
    dv = [deriv(v, D, a) * metrics[a] for a in range(3)]
    dE = torch.stack(
        [
            dv[0][:, 0],
            dv[1][:, 1],
            dv[2][:, 2],
            0.5 * (dv[2][:, 1] + dv[1][:, 2]),
            0.5 * (dv[2][:, 0] + dv[0][:, 2]),
            0.5 * (dv[1][:, 0] + dv[0][:, 1]),
        ],
        dim=1,
    )
    S = stress(q, lam, mu)
    dS = [deriv(S, D, a) * metrics[a] for a in range(3)]
    rho_ = rho[:, None, None, None]
    dvx = (dS[0][:, SYM[0, 0]] + dS[1][:, SYM[0, 1]] + dS[2][:, SYM[0, 2]]) / rho_
    dvy = (dS[0][:, SYM[1, 0]] + dS[1][:, SYM[1, 1]] + dS[2][:, SYM[1, 2]]) / rho_
    dvz = (dS[0][:, SYM[2, 0]] + dS[1][:, SYM[2, 1]] + dS[2][:, SYM[2, 2]]) / rho_
    return torch.cat([dE, torch.stack([dvx, dvy, dvz], dim=1)], dim=1)


def extract_face(u: torch.Tensor, face: int) -> torch.Tensor:
    """interp_q (LGL collocation: a slice).  u (K, F, M, M, M) -> a strided
    (K, F, M, M) view."""
    ax = FACE_AXIS[face]
    last = u.shape[2 + ax] - 1
    idx = 0 if FACE_SIGN[face] < 0 else last
    if ax == 0:
        return u[:, :, idx, :, :]
    if ax == 1:
        return u[:, :, :, idx, :]
    return u[:, :, :, :, idx]


def riemann_correction(
    Sm: torch.Tensor,  # (K, 6, M, M) minus-side stress at face nodes
    vm: torch.Tensor,  # (K, 3, M, M)
    Sp: torch.Tensor,
    vp: torch.Tensor,
    axis: int,
    sign: float,
    mat_m: Dict[str, torch.Tensor],  # rho, cp, cs, mu — (K,) minus side
    mat_p: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """n.(F* - F) for strain (K,6,M,M) and velocity (K,3,M,M)."""
    e = lambda x: x[:, None, None]
    k0 = 1.0 / (e(mat_m["rho"] * mat_m["cp"]) + e(mat_p["rho"] * mat_p["cp"]))
    denom_s = e(mat_m["rho"] * mat_m["cs"]) + e(mat_p["rho"] * mat_p["cs"])
    # k1 = 0 where the minus side is acoustic (mu^- = 0); the clamp is the
    # reference's 1e-300, which rounds to 0 in float32
    zero = torch.zeros((), dtype=denom_s.dtype, device=denom_s.device)
    k1 = torch.where(e(mat_m["mu"]) > 0, 1.0 / torch.clamp_min(denom_s, 1e-300), zero)

    S_j = Sm - Sp
    v_j = vm - vp
    a0, a1, a2 = axis, (axis + 1) % 3, (axis + 2) % 3
    S_aa = S_j[:, SYM[a0, a0]]
    S_a1 = S_j[:, SYM[a0, a1]]
    S_a2 = S_j[:, SYM[a0, a2]]
    rcp_p = e(mat_p["rho"] * mat_p["cp"])
    rcs_p = e(mat_p["rho"] * mat_p["cs"])
    rcp_m = e(mat_m["rho"] * mat_m["cp"])
    rcs_m = e(mat_m["rho"] * mat_m["cs"])

    a = k0 * (S_aa + rcp_p * sign * v_j[:, a0])
    FE = torch.zeros_like(S_j)
    FE[:, SYM[a0, a0]] = a
    FE[:, SYM[a0, a1]] = 0.5 * k1 * (S_a1 + rcs_p * sign * v_j[:, a1])
    FE[:, SYM[a0, a2]] = 0.5 * k1 * (S_a2 + rcs_p * sign * v_j[:, a2])

    Fv = torch.zeros_like(v_j)
    Fv[:, a0] = a * rcp_m * sign
    Fv[:, a1] = k1 * rcs_m * (sign * S_a1 + rcs_p * v_j[:, a1])
    Fv[:, a2] = k1 * rcs_m * (sign * S_a2 + rcs_p * v_j[:, a2])
    return FE, Fv


def surface_rhs(
    q: torch.Tensor,  # (K, 9, M, M, M)
    neighbors: torch.Tensor,  # (K, 6) int64: id, -1 (boundary) or -2 (skip)
    lift: Tuple[float, float, float],  # metric(a)/w_edge per axis
    rho: torch.Tensor,
    lam: torch.Tensor,
    mu: torch.Tensor,
    cp: torch.Tensor,
    cs: torch.Tensor,
    kernel_impl: str = "auto",
) -> torch.Tensor:
    """int_flux + bound_flux + lift: Riemann corrections on all 6 faces.

    ``kernel_impl`` selects the Riemann-flux body (``kernels/ops.py``):
    ``"cuda"`` launches the ``dg_flux`` kernel once per face direction.
    """
    from repro_torch.kernels import ops  # here: kernels.ref imports this module

    ops.check_impl(kernel_impl, q)
    S = stress(q, lam, mu)
    out = torch.zeros_like(q)
    mats = {"rho": rho, "cp": cp, "cs": cs, "mu": mu}
    for face in range(6):
        ax = FACE_AXIS[face]
        sign = FACE_SIGN[face]
        nbr = neighbors[:, face]
        has_nbr = nbr >= 0
        skip = nbr == -2  # cross-partition face: handled by the halo pass
        nbr_safe = torch.clamp_min(nbr, 0)

        Sm = extract_face(S, face)
        vm = extract_face(q[:, 6:9], face)
        Sp = extract_face(S, OPPOSITE[face])[nbr_safe]
        vp = extract_face(q[:, 6:9], OPPOSITE[face])[nbr_safe]
        # physical boundary: traction-free mirror [v]=0, S_j = 2 S^- n
        hn = has_nbr[:, None, None, None]
        Sp = torch.where(hn, Sp, -Sm)
        vp = torch.where(hn, vp, vm)
        mat_m = mats
        mat_p = {k: torch.where(has_nbr, v[nbr_safe], v) for k, v in mats.items()}

        if kernel_impl == "torch":
            FE, Fv = riemann_correction(Sm, vm, Sp, vp, ax, sign, mat_m, mat_p)
        else:
            mats8 = torch.stack(
                [mat_m["rho"], mat_m["cp"], mat_m["cs"], mat_m["mu"],
                 mat_p["rho"], mat_p["cp"], mat_p["cs"], mat_p["mu"]],
                dim=1,
            )
            FE, Fv = ops.dg_flux(Sm.contiguous(), vm.contiguous(), Sp, vp, mats8,
                                 ax, sign, impl=kernel_impl)
        corr = torch.cat([FE, Fv / rho[:, None, None, None]], dim=1)
        corr = -lift[ax] * corr
        corr = corr.masked_fill(skip[:, None, None, None], 0.0)
        last = q.shape[2 + ax] - 1
        idx = 0 if sign < 0 else last
        if ax == 0:
            out[:, :, idx, :, :] += corr
        elif ax == 1:
            out[:, :, :, idx, :] += corr
        else:
            out[:, :, :, :, idx] += corr
    return out


def volume_rhs_impl(q, D, metrics, rho, lam, mu, kernel_impl: str = "auto"):
    """``volume_rhs`` behind the kernel switch: ``"cuda"`` launches the
    ``dg_volume`` kernel."""
    from repro_torch.kernels import ops  # here: kernels.ref imports this module

    return ops.dg_volume(q, D, metrics, rho, lam, mu, impl=kernel_impl)


def dg_rhs(q, D, metrics, lift, neighbors, rho, lam, mu, cp, cs, kernel_impl: str = "auto"):
    vol = volume_rhs_impl(q, D, metrics, rho, lam, mu, kernel_impl=kernel_impl)
    return vol + surface_rhs(q, neighbors, lift, rho, lam, mu, cp, cs,
                             kernel_impl=kernel_impl)
