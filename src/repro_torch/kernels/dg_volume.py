"""The paper's ``volume_loop`` as a hand-written CUDA kernel
(``csrc/dg_volume.cu``), replacing the Pallas TPU kernel
``repro.kernels.dg_volume.dg_volume_pallas``.

``dg_volume`` launches the kernel on CUDA tensors and uses the plain PyTorch
version (``ref.dg_volume_ref``) on CPU tensors; it never falls back from one
to the other.  ``dg_volume.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import check_operands
from repro_torch.kernels.ref import dg_volume_ref


def dg_volume(
    q: torch.Tensor,  # (K, 9, M, M, M)
    D: torch.Tensor,  # (M, M)
    metrics: Tuple[float, float, float],
    rho: torch.Tensor,  # (K,)
    lam: torch.Tensor,
    mu: torch.Tensor,
) -> torch.Tensor:
    """Volume rhs (K, 9, M, M, M): sym(grad v) and div(S)/rho."""
    if q.device.type == "cpu":
        return dg_volume_ref(q, D, metrics, rho, lam, mu)
    if q.dim() != 5 or q.shape[1] != 9:
        raise ValueError(f"dg_volume: q must be (K, 9, M, M, M), got {tuple(q.shape)}")
    K, _, M = q.shape[:3]
    check_operands(
        "dg_volume",
        {"q": q, "D": D, "rho": rho, "lam": lam, "mu": mu},
        {"q": (K, 9, M, M, M), "D": (M, M), "rho": (K,), "lam": (K,), "mu": (K,)},
    )
    out = torch.empty_like(q)
    if K == 0:
        return out
    lib = build.library()
    fn = lib.dg_volume_f64 if q.dtype == torch.float64 else lib.dg_volume_f32
    m0, m1, m2 = (float(m) for m in metrics)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), D.data_ptr(), rho.data_ptr(), lam.data_ptr(),
                 mu.data_ptr(), out.data_ptr(), K, M, m0, m1, m2, stream)
    build.check(err, "dg_volume")
    dg_volume.launches += 1
    return out


dg_volume.launches = 0
