"""The exact Riemann (Godunov) face correction as a hand-written CUDA kernel
(``csrc/dg_flux.cu``), replacing the Pallas TPU kernel
``repro.kernels.dg_flux.dg_flux_pallas``.

``dg_flux`` launches the kernel on CUDA tensors and uses the plain PyTorch
version (``ref.dg_flux_ref``) on CPU tensors; it never falls back from one
to the other.  The kernel takes contiguous operands only: callers pass face
slices through ``.contiguous()``, and a strided view raises instead of being
read as garbage.  ``dg_flux.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import check_operands
from repro_torch.kernels.ref import dg_flux_ref


def dg_flux(
    Sm: torch.Tensor,  # (F, 6, M, M)
    vm: torch.Tensor,  # (F, 3, M, M)
    Sp: torch.Tensor,
    vp: torch.Tensor,
    mats: torch.Tensor,  # (F, 8): rho-,cp-,cs-,mu-,rho+,cp+,cs+,mu+
    axis: int,
    sign: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Strain correction FE (F, 6, M, M) and velocity correction Fv
    (F, 3, M, M) across faces of normal ``sign * e_axis``."""
    if Sm.device.type == "cpu":
        return dg_flux_ref(Sm, vm, Sp, vp, mats, axis, sign)
    if Sm.dim() != 4 or Sm.shape[1] != 6:
        raise ValueError(f"dg_flux: Sm must be (F, 6, M, M), got {tuple(Sm.shape)}")
    if axis not in (0, 1, 2):
        raise ValueError(f"dg_flux: axis must be 0, 1 or 2, got {axis}")
    F, _, M, _ = Sm.shape
    check_operands(
        "dg_flux",
        {"Sm": Sm, "vm": vm, "Sp": Sp, "vp": vp, "mats": mats},
        {"Sm": (F, 6, M, M), "vm": (F, 3, M, M), "Sp": (F, 6, M, M),
         "vp": (F, 3, M, M), "mats": (F, 8)},
    )
    FE = torch.empty_like(Sm)
    Fv = torch.empty_like(vm)
    if F == 0:
        return FE, Fv
    lib = build.library()
    fn = lib.dg_flux_f64 if Sm.dtype == torch.float64 else lib.dg_flux_f32
    with torch.cuda.device(Sm.device):
        stream = torch.cuda.current_stream(Sm.device).cuda_stream
        err = fn(Sm.data_ptr(), vm.data_ptr(), Sp.data_ptr(), vp.data_ptr(),
                 mats.data_ptr(), FE.data_ptr(), Fv.data_ptr(), F, M * M,
                 int(axis), float(sign), stream)
    build.check(err, "dg_flux")
    dg_flux.launches += 1
    return FE, Fv


dg_flux.launches = 0
