"""Model configuration and shared building blocks of the LM stack, in
PyTorch.

The JAX package keeps float32 master weights and casts each matrix to the
activation dtype at every use; the port casts matrices, embeddings and
biases to the activation dtype once, at load, which gives the same values,
and keeps norm scales in float32 (``rmsnorm`` reads them in float32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LANE = 128  # vocab and head paddings align to this (the reference's TPU lane)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
          "float64": torch.float64}


def pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return DTYPES[str(name)]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Every field of the reference's ``ModelConfig``; ``kernel_impl`` takes
    the port's values (``"auto" | "torch" | "cuda"``, see ``kernels.ops``)."""

    arch_id: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int  # logical (published) q heads; 0 for attn-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int  # logical (published)
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    causal: bool = True
    mlp_type: str = "gated_silu"  # gated_silu | gelu
    sliding_window: Optional[int] = None
    global_layers: Tuple[int, ...] = ()
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "ep"
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0
    n_meta_tokens: int = 0
    frontend_tokens: int = 0
    use_conv_pos: bool = False
    flash_skip: bool = False
    attn_block_q: int = 512
    attn_block_k: int = 512
    ssm_scan: str = "assoc"
    ssm_chunk: int = 128
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kernel_impl: str = "auto"  # auto | torch | cuda
    remat: str = "full"
    tp_size: int = 1

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, LANE)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# GQA head sharding plan (numpy copy of the reference's)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HeadShardingPlan:
    """Padded head layout that makes GQA shard on a fixed model axis of
    ``tp`` devices.  With ``tp=1`` it is the logical model: no padding, and
    ``kv_dup`` is the identity.  Padded q heads are masked after attention,
    so the padded model is exactly the logical model."""

    q_heads: int
    kv_heads: int
    tp: int
    padded_q: int
    padded_kv: int
    kv_replicated: bool
    kv_dup: Tuple[int, ...]  # padded kv head -> logical kv head
    q_to_kv: Tuple[int, ...]  # padded q head -> padded kv head
    q_slot_of_logical: Tuple[int, ...]  # logical q head -> padded slot


def make_head_plan(q_heads: int, kv_heads: int, tp: int) -> HeadShardingPlan:
    q_per_g = q_heads // kv_heads
    assert q_heads % kv_heads == 0, (q_heads, kv_heads)
    if kv_heads % tp == 0 or tp % kv_heads == 0:
        if kv_heads % tp == 0:
            rep = 1
            padded_kv = kv_heads
        else:
            rep = tp // kv_heads
            padded_kv = tp
        bucket = -(-q_per_g // rep)
        padded_q = padded_kv * bucket
        kv_dup = tuple(j // rep for j in range(padded_kv))
        q_to_kv = tuple(h // bucket for h in range(padded_q))
        slot = []
        for h in range(q_heads):
            g, i = divmod(h, q_per_g)
            r, k = divmod(i, bucket)
            slot.append((g * rep + r) * bucket + k)
        return HeadShardingPlan(
            q_heads, kv_heads, tp, padded_q, padded_kv, False, kv_dup, q_to_kv, tuple(slot)
        )
    padded_q = pad_to(q_heads, tp)
    kv_dup = tuple(range(kv_heads))
    q_to_kv = tuple((h // q_per_g) if h < q_heads else 0 for h in range(padded_q))
    slot = tuple(range(q_heads))
    return HeadShardingPlan(q_heads, kv_heads, tp, padded_q, kv_heads, True, kv_dup, q_to_kv, slot)


# ---------------------------------------------------------------------------
# Initializers (on an explicit torch.Generator) and primitive layers
# ---------------------------------------------------------------------------


def normal_(t: torch.Tensor, gen: torch.Generator, scale: float) -> torch.Tensor:
    """Fill ``t`` with normals times ``scale``, drawn in float32 from
    ``gen`` (on ``t``'s device) and cast to ``t``'s dtype."""
    draw = torch.randn(t.shape, generator=gen, device=t.device, dtype=torch.float32)
    with torch.no_grad():
        t.copy_(draw.mul_(scale))
    return t


def dense_init_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Fan-in-scaled normals for a (d_in, d_out) matrix."""
    return normal_(w, gen, 1.0 / math.sqrt(w.shape[0]))


def embed_init_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    return normal_(w, gen, 1.0)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Computes in float32 and casts back to ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, rotary_pct: float = 1.0) -> np.ndarray:
    rot = int(head_dim * rotary_pct) // 2 * 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    return inv.astype(np.float32)  # (rot/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """x (..., S, D), positions (..., S) integer; rotates the first
    ``2 * len(inv_freq)`` channels in the neox layout.  cos and sin are cast
    to ``x``'s dtype before the multiply, as the reference does."""
    rot = 2 * inv_freq.shape[0]
    ang = positions[..., None].float() * inv_freq
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out


def gated_mlp_apply(p, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """``p`` maps names to weights already in ``x``'s dtype."""
    if mlp_type == "gated_silu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if mlp_type == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
        return h @ p["w_down"] + p["b_down"]
    raise ValueError(mlp_type)
