"""Transformer blocks of the LM stack, dense branch, in PyTorch.

Functions take a ``Block`` (its ``attn`` and ``mlp`` parameter dicts, its
``ln2`` scale) and the model config, as the reference's take a parameter
tree.  With the head plan of ``tp_size=1`` the padded model is the logical
model: the kv duplication and the padded-head mask are identities and are
skipped (both are exact).  There is no mesh on one card, so the reference's
``shard(...)`` constraints have no counterpart.

Configs with experts, SSM state, meta tokens or a frontend raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.attention import (
    CacheLen,
    decode_attention,
    flash_attention,
    update_cache,
)
from repro_torch.models.common import (
    HeadShardingPlan,
    ModelConfig,
    apply_rope,
    gated_mlp_apply,
    rmsnorm,
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    if cfg.n_experts or cfg.family == "moe":
        raise NotImplementedError(f"{cfg.arch_id}: MoE layers are not ported yet (ROADMAP A15)")
    if cfg.has_ssm or cfg.family in ("ssm", "hybrid") or cfg.n_meta_tokens:
        raise NotImplementedError(
            f"{cfg.arch_id}: SSM and hybrid layers are not ported yet (ROADMAP A16)")
    if cfg.family in ("vlm", "audio") or cfg.frontend_tokens or cfg.use_conv_pos:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family} frontend is not ported yet (ROADMAP A14)")
    if cfg.family != "dense" or not cfg.has_attention:
        raise NotImplementedError(f"{cfg.arch_id}: family {cfg.family!r} is not ported yet")


# ---------------------------------------------------------------------------
# Layer schedule: contiguous segments of identical layer kind
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    start: int
    count: int
    window: Optional[int]  # None = full attention for this segment


def layer_schedule(cfg: ModelConfig) -> List[Segment]:
    L = cfg.n_layers
    if not cfg.has_attention or cfg.sliding_window is None or not cfg.global_layers:
        w = cfg.sliding_window if cfg.has_attention else None
        return [Segment(0, L, w)]
    segs: List[Segment] = []
    glob = set(cfg.global_layers)
    i = 0
    while i < L:
        if i in glob:
            segs.append(Segment(i, 1, None))
            i += 1
        else:
            j = i
            while j < L and j not in glob:
                j += 1
            segs.append(Segment(i, j - i, cfg.sliding_window))
            i = j
    return segs


# ---------------------------------------------------------------------------
# Parameters of one block
# ---------------------------------------------------------------------------


def _param(shape, dtype, device, fill: Optional[float] = None) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One dense block's weights: ``attn`` (wq, wk, wv, wo as (d_in, d_out)
    matrices, biases, ``ln``), ``mlp`` and ``ln2``.  Matrices and biases are
    in the activation dtype, norm scales in float32."""

    def __init__(self, cfg: ModelConfig, plan: HeadShardingPlan, device: torch.device):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim_
        adt, f32 = cfg.activation_dtype, torch.float32
        attn = {
            "wq": _param((d, plan.padded_q * hd), adt, device),
            "wk": _param((d, plan.kv_heads * hd), adt, device),
            "wv": _param((d, plan.kv_heads * hd), adt, device),
            "wo": _param((plan.padded_q * hd, d), adt, device),
            "ln": _param((d,), f32, device, 1.0),
        }
        if cfg.qkv_bias:
            attn["bq"] = _param((plan.padded_q * hd,), adt, device, 0.0)
            attn["bk"] = _param((plan.kv_heads * hd,), adt, device, 0.0)
            attn["bv"] = _param((plan.kv_heads * hd,), adt, device, 0.0)
        self.attn = nn.ParameterDict(attn)
        f = cfg.d_ff
        if cfg.mlp_type == "gated_silu":
            mlp = {"w_gate": _param((d, f), adt, device), "w_up": _param((d, f), adt, device),
                   "w_down": _param((f, d), adt, device)}
        else:
            mlp = {"w_up": _param((d, f), adt, device), "b_up": _param((f,), adt, device, 0.0),
                   "w_down": _param((f, d), adt, device), "b_down": _param((d,), adt, device, 0.0)}
        self.mlp = nn.ParameterDict(mlp)
        self.ln2 = _param((d,), f32, device, 1.0)

    def dense_weights(self) -> List[torch.Tensor]:
        """The fan-in-scaled matrices, in the reference's init order."""
        a, m = self.attn, self.mlp
        mlp = ([m["w_gate"], m["w_up"], m["w_down"]] if "w_gate" in m
               else [m["w_up"], m["w_down"]])
        return [a["wq"], a["wk"], a["wv"], a["wo"], *mlp]


# ---------------------------------------------------------------------------
# Attention sublayer
# ---------------------------------------------------------------------------


def _head_mask(plan: HeadShardingPlan) -> np.ndarray:
    m = np.zeros(plan.padded_q, np.float32)
    for s in plan.q_slot_of_logical:
        m[s] = 1.0
    return m


def _mask_padded_heads(out: torch.Tensor, plan: HeadShardingPlan) -> torch.Tensor:
    if plan.padded_q == plan.q_heads:
        return out  # no padded heads: the mask is all ones
    m = torch.as_tensor(_head_mask(plan), dtype=out.dtype, device=out.device)
    return out * m[None, :, None, None]


def _qkv(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
         plan: HeadShardingPlan, positions: torch.Tensor, inv_freq: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.view(B, S, plan.padded_q, hd).transpose(1, 2)
    k = k.view(B, S, plan.kv_heads, hd).transpose(1, 2)
    v = v.view(B, S, plan.kv_heads, hd).transpose(1, 2)
    q = apply_rope(q, positions[:, None, :], inv_freq)
    k = apply_rope(k, positions[:, None, :], inv_freq)
    if not plan.kv_replicated and plan.kv_dup != tuple(range(plan.kv_heads)):
        # expand logical kv -> padded/duplicated kv heads
        idx = torch.as_tensor(plan.kv_dup, dtype=torch.long, device=x.device)
        k, v = k.index_select(1, idx), v.index_select(1, idx)
    return q, k, v


def attn_apply(p, x, cfg: ModelConfig, plan: HeadShardingPlan, *, window: Optional[int],
               positions, inv_freq, q_offset: int = 0
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention; returns (out, (k, v)), k/v for cache builds."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, plan, positions, inv_freq)
    kv_map = plan.q_to_kv if plan.kv_replicated else None
    out = flash_attention(q, k, v, causal=cfg.causal, window=window, q_offset=q_offset,
                          kv_map=kv_map, impl=cfg.kernel_impl)
    out = _mask_padded_heads(out, plan)
    out = out.transpose(1, 2).reshape(B, S, plan.padded_q * cfg.head_dim_)
    return out @ p["wo"], (k, v)


def attn_decode(p, x_t, kcache, vcache, cache_len: CacheLen, cfg: ModelConfig,
                plan: HeadShardingPlan, *, window: Optional[int], inv_freq):
    """One token (B, d) against the layer's caches (B, G, C, hd), which are
    written in place."""
    B = x_t.shape[0]
    hd = cfg.head_dim_
    rolling = window is not None and kcache.shape[2] == window
    if isinstance(cache_len, torch.Tensor) and cache_len.dim():
        pos = cache_len.to(device=x_t.device, dtype=torch.long)[:, None]
    else:
        pos = torch.full((B, 1), int(cache_len), dtype=torch.long, device=x_t.device)
    q, k, v = _qkv(p, x_t[:, None, :], cfg, plan, pos, inv_freq)
    kcache, vcache = update_cache(kcache, vcache, k, v, cache_len, rolling=rolling)
    kv_map = plan.q_to_kv if plan.kv_replicated else None
    out = decode_attention(q, kcache, vcache, cache_len + 1, window=window, rolling=rolling,
                           kv_map=kv_map)
    out = _mask_padded_heads(out, plan)
    out = out.transpose(1, 2).reshape(B, 1, plan.padded_q * hd)
    return (out @ p["wo"])[:, 0], kcache, vcache


# ---------------------------------------------------------------------------
# Blocks (dense)
# ---------------------------------------------------------------------------


def block_apply(blk: Block, x, cfg: ModelConfig, plan: HeadShardingPlan, *, window,
                positions, inv_freq, q_offset: int = 0, collect_seed: bool = False):
    """Returns (x_out, seed); ``seed["kv"]`` is the layer's (k, v) when
    ``collect_seed``, what a decode cache is built from."""
    seed: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    h = rmsnorm(x, blk.attn["ln"], cfg.norm_eps)
    a_out, kv = attn_apply(blk.attn, h, cfg, plan, window=window, positions=positions,
                           inv_freq=inv_freq, q_offset=q_offset)
    if collect_seed:
        seed["kv"] = kv
    x = x + a_out
    if cfg.d_ff > 0:
        h = rmsnorm(x, blk.ln2, cfg.norm_eps)
        x = x + gated_mlp_apply(blk.mlp, h, cfg.mlp_type)
    return x, seed


def block_decode(blk: Block, x_t, kcache, vcache, cache_len: CacheLen, cfg: ModelConfig,
                 plan: HeadShardingPlan, *, window, inv_freq):
    """One token through one block; the layer's caches are written in place."""
    h = rmsnorm(x_t[:, None, :], blk.attn["ln"], cfg.norm_eps)[:, 0]
    a_out, _, _ = attn_decode(blk.attn, h, kcache, vcache, cache_len, cfg, plan,
                              window=window, inv_freq=inv_freq)
    x_t = x_t + a_out
    if cfg.d_ff > 0:
        h = rmsnorm(x_t[:, None, :], blk.ln2, cfg.norm_eps)[:, 0]
        x_t = x_t + gated_mlp_apply(blk.mlp, h, cfg.mlp_type)
    return x_t
