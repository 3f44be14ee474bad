"""Attention for the LM stack, in PyTorch: GQA, sliding window, decode.

Layouts are the reference's: q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D).

* ``naive_attention`` — materialized scores in the input dtype, the
  reference's oracle for tests.
* ``flash_attention`` — the reference's blocked attention signature, routed
  through ``kernels.ops.flash_attention_op`` by ``impl``: the hand-written
  CUDA kernel (``csrc/flash_attention.cu``) on the card, its plain version
  on the CPU.  ``block_q``, ``block_k`` and ``dynamic_skip`` change only the
  association of the reference's lax version; the kernel has its own tiles
  and always skips fully masked kv tiles.
* ``decode_attention`` / ``update_cache`` — one new token against a cache,
  in plain PyTorch (no TPU kernel computes them).  ``update_cache`` writes
  the caches in place, where the reference returns new arrays: the caches
  are the largest state of a serve, and copying them per token would
  double their traffic.

Ring attention needs a mesh and is not in this slice.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30

CacheLen = Union[int, torch.Tensor]  # a scalar for the batch, or per row (B,)


def pick_block(n: int, target: int) -> int:
    """Largest divisor of n that is <= target."""
    b = min(n, target)
    while n % b:
        b -= 1
    return b


def _expand_kv(k: torch.Tensor, kv_map: Sequence[int]) -> torch.Tensor:
    """Expand kv heads to one per q head by an index map."""
    idx = torch.as_tensor(list(kv_map), dtype=torch.long, device=k.device)
    return k.index_select(1, idx)


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    kv_map=None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference implementation (tests and tiny shapes only)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if kv_map is not None:
        k, v = _expand_kv(k, kv_map), _expand_kv(v, kv_map)
    elif Hq != Hkv:
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    scale = scale or 1.0 / math.sqrt(D)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    kv_map=None,
    block_q: int = 512,
    block_k: int = 512,
    scale: Optional[float] = None,
    dynamic_skip: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """Blocked attention, q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) ->
    (B, Hq, Sq, D).  A replicated-kv ``kv_map`` is expanded before the call,
    as the Pallas kernel's contract says; grouped GQA is read in place."""
    del block_q, block_k, dynamic_skip  # the kernel's own tiles; it always skips
    Hq, Hkv = q.shape[1], k.shape[1]
    if kv_map is not None:
        k, v = _expand_kv(k, kv_map), _expand_kv(v, kv_map)
    elif Hq % Hkv:
        raise ValueError(f"Hq {Hq} not a multiple of Hkv {Hkv}")
    return ops.flash_attention_op(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal, window=window,
        scale=scale, q_offset=q_offset, impl=impl,
    )


# ---------------------------------------------------------------------------
# Decode (one new token against a cache)
# ---------------------------------------------------------------------------


def decode_attention(
    q: torch.Tensor,  # (B, Hq, 1, D)
    k_cache: torch.Tensor,  # (B, Hkv, C, D)
    v_cache: torch.Tensor,
    cache_len: CacheLen,  # tokens written so far: scalar or per row (B,)
    *,
    window: Optional[int] = None,
    rolling: bool = False,
    kv_map=None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-step attention against a (possibly rolling) KV cache.  Every op is
    row-independent, so a row at length L computes what the scalar path
    computes at length L."""
    B, Hq, _, D = q.shape
    Hkv, C = k_cache.shape[1], k_cache.shape[2]
    scale = scale or 1.0 / math.sqrt(D)
    if kv_map is not None:
        k_cache, v_cache = _expand_kv(k_cache, kv_map), _expand_kv(v_cache, kv_map)
        Hkv = Hq
    grouped = Hq != Hkv
    if grouped:
        qg = q.reshape(B, Hkv, Hq // Hkv, D)
        s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache).float() * scale
    else:
        s = torch.einsum("bhqd,bhkd->bhqk", q, k_cache).float() * scale
    slots = torch.arange(C, device=q.device)[None, None, None, :]
    if isinstance(cache_len, torch.Tensor) and cache_len.dim():
        clen = cache_len.to(device=q.device, dtype=torch.long)[:, None, None, None]
        valid = slots < torch.clamp(clen, max=C)
    else:
        clen = int(cache_len)  # a host int: no copy to the device
        valid = slots < min(clen, C)
    if window is not None and not rolling:
        valid = valid & (slots >= clen - window)
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    if grouped:
        out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache)
        return out.reshape(B, Hq, 1, D)
    return torch.einsum("bhqk,bhkd->bhqd", p, v_cache)


def update_cache(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # (B, Hkv, 1, D)
    v_new: torch.Tensor,
    cache_len: CacheLen,
    rolling: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write the new token's k and v at slot ``cache_len`` (``% C`` when
    rolling), per row when ``cache_len`` is a (B,) vector.  In place;
    returns the caches."""
    C = k_cache.shape[2]
    if isinstance(cache_len, torch.Tensor) and cache_len.dim():
        pos = cache_len.to(device=k_cache.device, dtype=torch.long)
        pos = pos % C if rolling else pos
        rows = torch.arange(k_cache.shape[0], device=k_cache.device)
        k_cache[rows, :, pos, :] = k_new[:, :, 0].to(k_cache.dtype)
        v_cache[rows, :, pos, :] = v_new[:, :, 0].to(v_cache.dtype)
        return k_cache, v_cache
    pos = int(cache_len) % C if rolling else int(cache_len)
    k_cache[:, :, pos : pos + 1, :] = k_new.to(k_cache.dtype)
    v_cache[:, :, pos : pos + 1, :] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
