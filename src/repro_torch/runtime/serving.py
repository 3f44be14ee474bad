"""One-shot LM serving on the nested-partition runtime, in PyTorch.

A prompt batch is prefilled and decoded greedily.  Spliced across P
partitions, a calibration pass times each partition's prefill (the boundary
phase: per-request set-up) and decode (the interior phase) into a
``CalibrationReport``, and the executor re-solves the row split through
``plan_from_report``: the paper's calibrate -> solve -> resplice loop
applied to serving.

``decode_scan`` is an eager loop of one serve step per token, and
``DispatchStats`` records what it issues: one program per step.  The
reference compiles the loop into one program per sub-batch; the port gets
there with a CUDA-graph capture (ROADMAP A9).

Not in this slice: the continuous-batching loop (``ContinuousBatchingLoop``
with its SLOs, clocks, traces, chunked decode and row splices; ROADMAP A13).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.parallel.steps import greedy, make_serve_step
from repro_torch.runtime.executor import NestedPartitionExecutor
from repro_torch.runtime.schedule import CalibrationReport, DispatchStats

__all__ = ["ServeKernels", "build_lm", "calibrate_split", "decode_batch", "warm_batch"]


def build_lm(arch: str, *, smoke: bool = True, seed: int = 0, device: DeviceLike = None,
             dtype: Optional[str] = None, kernel_impl: str = "auto"):
    """Resolve an arch and build its LM with weights made from ``seed``.

    ``smoke`` takes the reduced CPU-test config; otherwise the published
    widths with ``tp_size=1``, whose head plan is the logical model (no
    padded heads).  ``dtype`` overrides the activation dtype.  ``device=None``
    means ``cuda`` and raises without a card.  Returns ``(cfg, lm)``;
    encoder-only archs are refused (nothing to decode)."""
    from repro_torch.configs.registry import resolve_arch
    from repro_torch.configs.shapes import smoke_config
    from repro_torch.models.zoo import LM

    dev = resolve_device(device)
    cfg = resolve_arch(arch)
    if cfg.is_encoder_only:
        raise ValueError(f"{cfg.arch_id} is encoder-only: no decode serving")
    cfg = smoke_config(cfg) if smoke else cfg.replace(tp_size=1)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    cfg = cfg.replace(kernel_impl=kernel_impl)
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
    return cfg, lm


class ServeKernels:
    """The serving programs for one ``(lm, max_len)``:

      * ``prefill_rows`` — prefill + greedy first token (``prefills`` counts
        the calls);
      * ``serve_step``   — one greedy decode step;
      * ``decode_scan``  — ``n`` greedy steps, an eager loop of ``n``
        serve steps.

    ``max_len`` is the cache capacity every call is built against."""

    def __init__(self, lm, max_len: int):
        self.lm = lm
        self.cfg = lm.cfg
        self.max_len = int(max_len)
        self.stats = DispatchStats()  # decode programs issued vs steps
        self.warmed: set = set()
        self.prefills = 0
        self.serve_step = make_serve_step(lm)

    def prefill_rows(self, rows: np.ndarray) -> Tuple[torch.Tensor, dict]:
        """Prefill a (b, S) prompt block; returns (first_tok (b,), cache)."""
        tokens = torch.as_tensor(np.asarray(rows), dtype=torch.long, device=self.lm.device)
        logits, cache = self.lm.prefill(tokens, max_len=self.max_len)
        self.prefills += 1
        return greedy(logits, self.cfg.vocab_size), cache

    def decode_scan(self, cache: dict, tok: torch.Tensor, n: int):
        """``n`` greedy steps; returns (toks (n, b), last tok, cache)."""
        toks = []
        for _ in range(n):
            tok, cache = self.serve_step(cache, tok)
            toks.append(tok)
        return torch.stack(toks), tok, cache


def decode_batch(kernels: ServeKernels, rows: np.ndarray, n_gen: int):
    """One-shot serve of a (b, S) prompt block: prefill + ``n_gen`` greedy
    tokens.  Returns ``(gen (b, n_gen) int32, prefill_s, decode_s)``, each
    time on the host clock around work that ends in a synchronize."""
    dev = kernels.lm.device
    synchronize(dev)
    t0 = time.perf_counter()
    tok, cache = kernels.prefill_rows(rows)
    synchronize(dev)
    t_prefill = time.perf_counter() - t0
    toks = [tok[None]]
    t1 = time.perf_counter()
    if n_gen > 1:
        rest, tok, _ = kernels.decode_scan(cache, tok, n_gen - 1)
        synchronize(dev)
        kernels.stats.record(n_gen - 1, n_gen - 1)
        toks.append(rest)
    t_decode = time.perf_counter() - t1
    gen = torch.cat(toks).T.cpu().numpy().astype(np.int32)
    return gen, t_prefill, t_decode


def warm_batch(kernels: ServeKernels, rows: np.ndarray, n_gen: int) -> None:
    """Serve one throwaway generation per distinct (rows, n_gen) shape, so a
    timed pass does not measure first-call costs (kernel loading, library
    heuristics, the allocator's growth)."""
    key = (len(rows), n_gen)
    if len(rows) and key not in kernels.warmed:
        decode_batch(kernels, rows, n_gen)
        kernels.warmed.add(key)


def calibrate_split(
    kernels: ServeKernels,
    prompts: np.ndarray,
    partitions: int,
    *,
    calib_gen: int = 4,
):
    """Calibration pass over ``partitions`` contiguous partitions of a
    prompt batch: time each partition's prefill (boundary phase) and decode
    (interior phase), build the ``CalibrationReport`` and re-solve the row
    split through ``plan_from_report``.  Returns ``(executor, report)`` with
    the calibrated counts applied."""
    P = max(1, min(int(partitions), len(prompts)))
    executor = NestedPartitionExecutor(len(prompts), P, bucket=1, smoothing=1.0)
    n = max(2, int(calib_gen))
    offs = executor.offsets
    t_prefill = np.zeros(P)
    t_decode = np.zeros(P)
    for p in range(P):
        rows = prompts[offs[p]: offs[p + 1]]
        if len(rows) == 0:
            continue
        warm_batch(kernels, rows, n)
        _, t_prefill[p], t_decode[p] = decode_batch(kernels, rows, n)
    report = CalibrationReport(boundary_s=t_prefill, interior_s=t_decode, transfer_s=np.zeros(P))
    executor.observe(report.step_s)
    executor.plan_from_report(report)
    return executor, report
