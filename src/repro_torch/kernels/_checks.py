"""Argument checks the CUDA wrappers run before handing pointers to a
kernel: one device, one floating dtype, the expected shapes, contiguity."""

from __future__ import annotations

from typing import Dict, Sequence

import torch

FLOAT_DTYPES = (torch.float32, torch.float64)


def check_operands(what: str, tensors: Dict[str, torch.Tensor],
                   shapes: Dict[str, Sequence[int]],
                   dtypes: Sequence[torch.dtype] = FLOAT_DTYPES) -> None:
    """Raise ``ValueError`` unless every tensor lies on the same CUDA device,
    has the same dtype (one of ``dtypes``), the given shape and is
    contiguous."""
    first = next(iter(tensors.values()))
    if first.dtype not in dtypes:
        raise ValueError(f"{what}: dtype must be one of {tuple(dtypes)}, got {first.dtype}")
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
