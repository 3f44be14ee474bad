"""Reduced same-family configs for the CPU tests (the reference's
``configs/shapes.py:smoke_config``)."""

from __future__ import annotations

from repro_torch.models.common import ModelConfig


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny widths and depths, runnable on one CPU."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.global_layers else 2),
        d_model=64,
        vocab_size=512,
        tp_size=1,
        remat="none",
        dtype="float32",
    )
    if cfg.has_attention:
        kw.update(n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4, head_dim=16)
    if cfg.d_ff:
        kw.update(d_ff=128)
    if cfg.n_experts:
        kw.update(n_experts=4, experts_per_token=2, capacity_factor=2.0)
    if cfg.has_ssm:
        kw.update(ssm_state=8)
    if cfg.sliding_window is not None:
        kw.update(sliding_window=32)
    if cfg.global_layers:
        kw.update(global_layers=(0, 3))
    if cfg.n_meta_tokens:
        kw.update(n_meta_tokens=8)
    if cfg.frontend_tokens:
        kw.update(frontend_tokens=16)
    if cfg.dt_rank:
        kw.update(dt_rank=8)
    return cfg.replace(**kw)
