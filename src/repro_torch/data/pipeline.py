"""Deterministic synthetic data: every draw is a pure function of
``(seed, step)`` (the reference's ``data/pipeline.py:_rng``)."""

from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))
