"""Blocked online-softmax attention as a hand-written CUDA kernel
(``csrc/flash_attention.cu``), replacing the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``.

``flash_attention`` launches the kernel on CUDA tensors and uses the plain
PyTorch version (``ref.flash_attention_ref``) on CPU tensors; it never falls
back from one to the other.  ``flash_attention.launches`` counts kernel
launches.  GQA is read in place (``Hq % Hkv == 0``); a replicated-kv head
map is expanded by the caller.

bf16 runs on the tensor cores (``wgmma`` fed by TMA, a producer and two
consumer warpgroups, P rounded to bf16 for p.v; ``bf16_tiling`` gives the
tiles of each head dim); float32 runs on f32 FMAs, which keep 5e-4.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import check_operands
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 80, 128, 160)  # compiled into the kernel
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID_Y = 65535  # B * Hq rides the float32 kernel's grid y dimension


def bf16_tiling(head_dim: int) -> dict:
    """The bf16 kernel's tiles at ``head_dim`` (``Tiles<D>`` in the source):
    every compiled dim runs on ``wgmma`` with TMA loads, its rows padded
    with zero columns to ``padded_dim``, a multiple of 64 (one 128-byte
    swizzle row per 64 columns); q tiles of ``block_q`` rows (64 per
    consumer warpgroup), kv tiles of ``block_k`` rows, 64 where 128 would
    not leave room for q and two K/V stages in shared memory."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {head_dim} not compiled; "
                         f"supported {HEAD_DIMS}")
    padded = -(-head_dim // 64) * 64
    return {"path": "wgmma+tma", "padded_dim": padded, "block_q": 128,
            "block_k": 128 if padded <= 128 else 64}


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention (B, Hq, Sq, D); causal, sliding-window or encoder."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                                   q_offset=q_offset)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must be 4-D, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    check_operands(
        "flash_attention", {"q": q, "k": k, "v": v},
        {"q": (B, Hq, Sq, D), "k": (B, Hkv, Skv, D), "v": (B, Hkv, Skv, D)},
        dtypes=DTYPES,
    )
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not compiled; supported {HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq {Hq} not a multiple of Hkv {Hkv}")
    if Skv == 0:
        raise ValueError("flash_attention: empty key sequence")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got {q_offset}")
    if q.dtype == torch.float32 and B * Hq > MAX_GRID_Y:
        raise ValueError(f"flash_attention: B * Hq = {B * Hq} exceeds {MAX_GRID_Y}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = build.library()
    fn = lib.flash_attention_bf16 if q.dtype == torch.bfloat16 else lib.flash_attention_f32
    scale = scale or 1.0 / math.sqrt(D)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sq, Skv, D,
                 float(scale), int(bool(causal)), -1 if window is None else int(window),
                 int(q_offset), stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
