"""The LM as an ``nn.Module`` (dense decoders), and the arch registry.

    lm = LM(cfg, device=...)
    lm.init(torch.Generator(device=...).manual_seed(seed))
    logits, cache = lm.prefill(tokens, max_len=...)   # last-position logits
    logits, cache = lm.decode_step(cache, tokens)     # one token per row

Layers are a ``ModuleList``, not a stacked scan.  A decode cache is a dict
``{"len": int or (B,) tensor, "seg{i}": {"k": (Lseg, B, G, C, hd), "v": ...}}``
as in the reference; ``decode_step`` writes it in place and returns it with
``len`` advanced.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import (
    ModelConfig,
    dense_init_,
    embed_init_,
    make_head_plan,
    rmsnorm,
    rope_freqs,
)
from repro_torch.models.transformer import (
    Block,
    block_apply,
    block_decode,
    check_supported,
    layer_schedule,
)


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.plan = make_head_plan(cfg.n_heads, cfg.n_kv_heads, cfg.tp_size)
        self.segments = layer_schedule(cfg)
        self.register_buffer(
            "inv_freq",
            torch.as_tensor(rope_freqs(cfg.head_dim_, cfg.rope_theta, cfg.rotary_pct), device=dev),
            persistent=False,
        )
        adt = cfg.activation_dtype
        self.embed = nn.Parameter(torch.empty((cfg.padded_vocab, cfg.d_model), dtype=adt,
                                              device=dev), requires_grad=False)
        self.layers = nn.ModuleList(Block(cfg, self.plan, dev) for _ in range(cfg.n_layers))
        self.final_ln = nn.Parameter(torch.ones(cfg.d_model, device=dev), requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty((cfg.d_model, cfg.padded_vocab), dtype=adt,
                                                    device=dev), requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def with_impl(self, kernel_impl: str) -> "LM":
        """The same model (shared weights) under another ``kernel_impl``."""
        other = copy.copy(self)
        other.cfg = self.cfg.replace(kernel_impl=kernel_impl)
        return other

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "LM":
        """The reference's init on ``gen``: normals for the embedding,
        fan-in-scaled normals for every matrix, ones for the norms, zeros
        for the biases (the last two are set at construction)."""
        embed_init_(self.embed, gen)
        if not self.cfg.tie_embeddings:
            dense_init_(self.lm_head, gen)
        for blk in self.layers:
            for w in blk.dense_weights():
                dense_init_(w, gen)
        return self

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------
    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, self.final_ln, self.cfg.norm_eps)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ head

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, collect_seed: bool = False,
                return_hidden: bool = False) -> Tuple[torch.Tensor, List[list]]:
        """tokens (B, S) -> (logits (B, S, V') or hidden (B, S, d), seeds):
        ``seeds[i]`` lists segment i's per-layer (k, v) when ``collect_seed``."""
        cfg = self.cfg
        x = self.embed[tokens]
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        seeds: List[list] = []
        for seg in self.segments:
            seg_seeds = []
            for li in range(seg.start, seg.start + seg.count):
                x, seed = block_apply(self.layers[li], x, cfg, self.plan, window=seg.window,
                                      positions=positions, inv_freq=self.inv_freq,
                                      collect_seed=collect_seed)
                if collect_seed:
                    seg_seeds.append(seed["kv"])
            seeds.append(seg_seeds)
        if return_hidden:
            return x, seeds
        return self._logits(x), seeds

    # ------------------------------------------------------------------
    # caches / serving
    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int) -> Dict:
        cfg = self.cfg
        G = self.plan.kv_heads if self.plan.kv_replicated else self.plan.padded_kv
        cache: Dict = {"len": 0}
        for si, seg in enumerate(self.segments):
            C = min(seg.window, max_len) if seg.window is not None else max_len
            shape = (seg.count, batch_size, G, C, cfg.head_dim_)
            cache[f"seg{si}"] = {
                "k": torch.zeros(shape, dtype=cfg.activation_dtype, device=self.device),
                "v": torch.zeros(shape, dtype=cfg.activation_dtype, device=self.device),
            }
        return cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence forward that also builds the decode cache; returns
        the logits of the LAST position only (B, V')."""
        hidden, seeds = self.forward(tokens, collect_seed=True, return_hidden=True)
        logits = self._logits(hidden[:, -1:, :])[:, 0]
        B, S = tokens.shape
        cache = self.init_cache(B, max_len or S)
        cache["len"] = S
        for si, _ in enumerate(self.segments):
            seg_c = cache[f"seg{si}"]
            C = seg_c["k"].shape[3]
            for j, (k, v) in enumerate(seeds[si]):  # (B, G, S, hd)
                if S >= C:
                    # rolling layout: token t lands in slot t % C
                    slots = (S - C + torch.arange(C, device=k.device)) % C
                    seg_c["k"][j][:, :, slots, :] = k[:, :, S - C:, :]
                    seg_c["v"][j][:, :, slots, :] = v[:, :, S - C:, :]
                else:
                    seg_c["k"][j][:, :, :S, :] = k
                    seg_c["v"][j][:, :, :S, :] = v
        return logits, cache

    @torch.no_grad()
    def decode_step(self, cache: Dict, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """One decoding step; tokens (B,).  ``cache["len"]`` is an int (one
        position for the batch) or a per-row (B,) tensor.  Returns (logits
        (B, V'), cache) with the cache written in place and ``len`` + 1."""
        cfg = self.cfg
        x = self.embed[tokens]
        clen = cache["len"]
        new_cache: Dict = {"len": clen + 1}
        for si, seg in enumerate(self.segments):
            seg_c = cache[f"seg{si}"]
            for j in range(seg.count):
                x = block_decode(self.layers[seg.start + j], x, seg_c["k"][j], seg_c["v"][j],
                                 clen, cfg, self.plan, window=seg.window,
                                 inv_freq=self.inv_freq)
            new_cache[f"seg{si}"] = seg_c
        return self._logits(x[:, None, :])[:, 0], new_cache


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registers the archs)

    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> List[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
