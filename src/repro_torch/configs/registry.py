"""Arch lookup for the CLIs (the reference's ``configs/registry.py`` arch
half): ``resolve_arch`` goes through the zoo registry, which importing
``repro_torch.configs`` populates.  Only ``qwen2-7b`` is registered so far;
the other archs of the reference wait for their families (ROADMAP A14-A16)."""

from __future__ import annotations

from typing import List

from repro_torch.models.common import ModelConfig


def resolve_arch(name: str) -> ModelConfig:
    """Arch id -> ``ModelConfig`` (KeyError lists the known ids)."""
    from repro_torch.models import zoo

    return zoo.get_config(name)


def list_archs() -> List[str]:
    from repro_torch.models import zoo

    return zoo.list_archs()


def format_listing() -> str:
    lines = ["archs:"]
    for a in list_archs():
        c = resolve_arch(a)
        lines.append(f"  {a:16s} {c.family:7s} L={c.n_layers} d={c.d_model} "
                     f"heads={c.n_heads}/{c.n_kv_heads} vocab={c.vocab_size}")
    return "\n".join(lines)
