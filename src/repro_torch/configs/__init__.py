"""Configurations the port runs: ``dg-paper`` (``dg_wave.CONFIG``) and the
registered LM archs (``qwen2_7b``); importing this package registers them
with ``repro_torch.models.zoo``."""

from repro_torch.configs import qwen2_7b  # noqa: F401  (registers the arch)
from repro_torch.configs.dg_wave import CONFIG, DGConfig

__all__ = ["CONFIG", "DGConfig"]
