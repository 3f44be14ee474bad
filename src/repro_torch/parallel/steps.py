"""The greedy serve step (the reference's ``parallel/steps.py:
make_serve_step``) without shardings."""

from __future__ import annotations

from typing import Callable

import torch


def greedy(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """argmax over the logical vocab (padded entries never win)."""
    pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
    return logits.masked_fill(pad, float("-inf")).argmax(dim=-1)


def make_serve_step(lm, *, masked: bool = False) -> Callable:
    """Greedy decode step.  ``masked=False``: ``(cache, tokens) -> (next_tok,
    cache)``.  ``masked=True``: ``(cache, tokens, active)``, where inactive
    rows hold their token and their per-row position ``cache["len"]`` (a
    (B,) tensor) frozen; their cache write lands at their slot and is
    overwritten on refill."""
    vocab = lm.cfg.vocab_size

    def serve_step(cache, tokens):
        logits, cache = lm.decode_step(cache, tokens)
        return greedy(logits, vocab), cache

    if not masked:
        return serve_step

    def serve_step_masked(cache, tokens, active):
        old_len = cache["len"]
        next_tok, new_cache = serve_step(cache, tokens)
        next_tok = torch.where(active, next_tok, tokens)
        new_cache["len"] = torch.where(active, new_cache["len"], old_len)
        return next_tok, new_cache

    return serve_step_masked
