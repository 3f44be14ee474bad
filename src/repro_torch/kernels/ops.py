"""Implementation selection for every kernel of the port.

impl:
  * "torch" — the plain PyTorch version (the role ``"xla"`` plays in the JAX
              package);
  * "cuda"  — the hand-written CUDA kernel (the role of ``"pallas"``);
              raises on a CPU tensor;
  * "auto"  — the kernel's wrapper, which launches the kernel on CUDA tensors
              and runs the plain version on CPU tensors.
A CUDA tensor under "auto" launches the kernel or raises: nothing falls back
to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.dg_flux import dg_flux as dg_flux_kernel
from repro_torch.kernels.dg_volume import dg_volume as dg_volume_kernel
from repro_torch.kernels.flash_attention import flash_attention as flash_attention_kernel

IMPLS = ("auto", "torch", "cuda")


def check_impl(impl: str, x: torch.Tensor) -> None:
    """Raise unless ``impl`` is one of ``IMPLS`` and, for ``"cuda"``, ``x``
    lies on a CUDA device."""
    if impl not in IMPLS:
        raise ValueError(f"kernel impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and x.device.type != "cuda":
        raise ValueError(f"kernel impl 'cuda' needs CUDA tensors, got {x.device}")


def dg_volume(q, D, metrics, rho, lam, mu, impl: str = "auto"):
    check_impl(impl, q)
    if impl == "torch":
        return ref.dg_volume_ref(q, D, metrics, rho, lam, mu)
    return dg_volume_kernel(q, D, metrics, rho, lam, mu)


def dg_flux(Sm, vm, Sp, vp, mats, axis, sign, impl: str = "auto"):
    check_impl(impl, Sm)
    if impl == "torch":
        return ref.dg_flux_ref(Sm, vm, Sp, vp, mats, axis, sign)
    return dg_flux_kernel(Sm, vm, Sp, vp, mats, axis, sign)


def flash_attention_op(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    scale: Optional[float] = None, q_offset: int = 0, impl: str = "auto",
):
    check_impl(impl, q)
    if impl == "torch":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                                       q_offset=q_offset)
    return flash_attention_kernel(q, k, v, causal=causal, window=window, scale=scale,
                                  q_offset=q_offset)
