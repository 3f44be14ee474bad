"""Argument checks the CUDA wrappers run before handing pointers to a
kernel: one device, one floating dtype, the expected shapes, contiguity."""

from __future__ import annotations

from typing import Dict, Sequence

import torch

FLOAT_DTYPES = (torch.float32, torch.float64)


def check_operands(what: str, tensors: Dict[str, torch.Tensor],
                   shapes: Dict[str, Sequence[int]]) -> None:
    """Raise ``ValueError`` unless every tensor lies on the same CUDA device,
    has the same float32/float64 dtype, the given shape and is contiguous."""
    first = next(iter(tensors.values()))
    if first.dtype not in FLOAT_DTYPES:
        raise ValueError(f"{what}: dtype must be float32 or float64, got {first.dtype}")
    for name, t in tensors.items():
        if t.dtype != first.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, expected {first.dtype}")
        if tuple(t.shape) != tuple(shapes[name]):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {tuple(shapes[name])}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.device != first.device:
            raise ValueError(f"{what}: {name} is on device {t.device}, expected {first.device}")
    if first.device.type != "cuda":
        raise ValueError(f"{what}: expected CUDA tensors, got {first.device}")
