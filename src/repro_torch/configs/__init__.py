"""Configurations the port runs (``dg-paper``: ``dg_wave.CONFIG``)."""

from repro_torch.configs.dg_wave import CONFIG, DGConfig

__all__ = ["CONFIG", "DGConfig"]
