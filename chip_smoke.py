#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero):

1. device  — the card's name and power limit; TF32 off;
2. build   — nvcc builds ``src/repro_torch/csrc/*.cu`` (one process per
             source, started together) into ``src/repro_torch/_build/``;
             prints ptxas' registers and spills, and counts the HGMMA
             (wgmma) instructions of each bf16 flash kernel in the built
             library's SASS, which must not be 0;
3. kernels — ``dg_volume`` and ``dg_flux`` against their plain PyTorch
             versions at the ``dg-paper`` shapes (K = F = 8192, order 7) and,
             for the volume kernel, the solver's own metrics and materials,
             in float64 and float32.  A kernel's time is device time: calls
             queued behind a spin kernel between one pair of CUDA events;
             one launch between its own events, which also reads the host's
             time to issue it, is printed beside it;
4. flat    — ``make_two_tree_solver`` at full width (32x16x16, order 7,
             float64) for 20 steps with the kernels and with the plain
             versions; they must agree and energy must not grow;
5. nested  — ``NestedPartitionExecutor`` (4 partitions) + ``BlockedDGEngine``:
             ``calibrate`` then ``run(q0, 20, observe=True)``, which must
             reproduce phase 4 and go through both kernels;
6. flash   — ``flash_attention`` against its plain version at the serving
             slice's shapes (B 2, Hq 28, Hkv 4, S 2048, D 128, causal) in
             bf16 and float32, over the reference kernel test's sweep and at
             head dims 80 and 160.  At the slice the kernel and
             ``scaled_dot_product_attention`` (a yardstick only: the port
             never calls it) are timed in turns on the device clock, beside
             the bound, the achieved TFLOP/s and the plain version; the
             path each bf16 head dim takes is printed;
7. serve   — ``qwen2-7b`` at its published widths and full depth in bf16,
             weights from seed 0, through the one-shot serve CLI's
             ``run_oneshot``: batch 4, prompt 2048, gen 32, 2 calibrated
             partitions.  Every prefill must launch the flash kernel once
             per layer and the tokens must lie in the logical vocab.  The
             kernel's last-position prefill logits must match the plain
             version's in float32 (same weights, built in float32) to 5e-4
             of max|logits|, and in bf16 to within twice the bf16 noise,
             max|plain bf16 - plain float32|.

Prints one ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits 1 and prints no result.  It imports nothing of JAX.
"""

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs.dg_wave import CONFIG  # noqa: E402
from repro_torch.dg.operators import FACE_AXIS, FACE_SIGN  # noqa: E402
from repro_torch.dg.solver import gaussian_pulse, make_two_tree_solver  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.dg_flux import dg_flux  # noqa: E402
from repro_torch.kernels.dg_volume import dg_volume  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS, bf16_tiling, flash_attention)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.bench_flash import device_ms  # noqa: E402
from repro_torch.runtime.executor import BlockedDGEngine, NestedPartitionExecutor  # noqa: E402
from repro_torch.runtime.serving import build_lm, decode_batch  # noqa: E402

SEED = 0
STEPS = 20
EXTENT = (2.0, 1.0, 1.0)
TOL = {torch.float64: 1e-11, torch.float32: 5e-4}  # tests/test_kernels.py:_tol
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12,  # non-tensor-core peaks
              torch.bfloat16: 989e12}  # dense tensor-core bf16
FLASH_TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-2}  # tests/test_kernels.py:test_flash_kernel
LOGITS_F32_TOL = FLASH_TOL[torch.float32]  # of max|logits|, kernel vs plain float32 prefill
BF16_NOISE_MULT = 2.0  # bf16 kernel vs plain prefill, in units of the bf16-vs-float32 gap
# the serving slice: qwen2-7b's attention on a sub-batch of 2 rows of 2048
SLICE = dict(B=2, Hq=28, Hkv=4, S=2048, D=128)
SERVE_ARGS = ["--arch", "qwen2-7b", "--batch", "4", "--prompt-len", "2048", "--gen", "32",
              "--partitions", "2", "--seed", str(SEED), "--dtype", "bfloat16", "--device", "cuda"]
TIMING_REPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def sass_count(mnemonic: str) -> dict:
    """How many ``mnemonic`` instructions each bf16 flash kernel of the
    built library holds, by head dim (``cuobjdump -sass``, beside nvcc)."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path())], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, dim = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_bf16_kernelILi(\d+)E", line)
            dim = int(m.group(1)) if m else None
            if dim is not None:
                counts[dim] = 0
        elif dim is not None and mnemonic in line:
            counts[dim] += 1
    return counts


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` launches, each between
    its own pair of CUDA events, after one warmup.  The card may wait
    between the first event and the work for the host to issue it, so a
    call shorter than its own Python overhead reads that overhead."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.median(ts)


def bound_ms(n_bytes: float, n_flops: float, dtype) -> tuple:
    """Least time for the work (bytes over HBM rate vs flops over peak) and
    which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} values off, max abs err {float(err.max()):.3e}")
    return float(err.max())


def check_scaled(name: str, got, want, scale, tol: float) -> tuple:
    """``|got - want| <= tol * (1 + scale)`` everywhere.  Two roundings of a
    sum differ by up to a few ulps of its terms, not of its result: where
    large derivative terms cancel, a bound relative to ``|want|`` fails on
    rounding alone.  A wrong stencil or a missing field moves an output by
    a sizeable part of ``scale`` and still fails.  Returns the max abs error
    and the max of ``|got - want| / (1 + scale)``."""
    err = (got - want).abs()
    rel = err / (1 + scale)
    bad = rel > tol
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} values off, max abs err "
                             f"{float(err.max()):.3e}, max err/(1+scale) {float(rel.max()):.3e}")
    return float(err.max()), float(rel.max())


def phase_kernels(gen: torch.Generator, solver) -> dict:
    """Phase 3: each kernel against its plain version at main-path shapes:
    the volume kernel with the solver's own D, metrics and materials on a
    random field, the flux kernel on random faces with one third acoustic."""
    K, M = solver.mesh.K, solver.M
    out = {}
    for dtype in (torch.float64, torch.float32):
        dev = dict(device="cuda", dtype=dtype)
        q = torch.randn((K, 9, M, M, M), generator=gen, **dev)
        args = (q, solver.D.to(dtype), solver.metrics, solver.rho_t.to(dtype),
                solver.lam_t.to(dtype), solver.mu_t.to(dtype))
        got, want = dg_volume(*args), ref.dg_volume_ref(*args)
        scale = ref.dg_volume_term_scale(*args)
        torch.cuda.synchronize()
        err, rel = check_scaled(f"dg_volume {dtype}", got, want, scale, TOL[dtype])
        del got, want, scale
        item = q.element_size()
        n_bytes = (2 * K * 9 * M**3 + M * M + 3 * K) * item
        n_flops = K * M**3 * (36 * M + 47)
        b, by = bound_ms(n_bytes, n_flops, dtype)
        out.setdefault("dg_volume", {})[dtype] = dict(
            max_abs_err=err, max_err_over_scale=rel, ms=device_ms(lambda: dg_volume(*args)),
            ms_event_pair=time_ms(lambda: dg_volume(*args)),
            plain_ms=time_ms(lambda: ref.dg_volume_ref(*args)), bound_ms=b, bound_by=by)
        del q, args

        F = K
        Sm = torch.randn((F, 6, M, M), generator=gen, **dev)
        vm = torch.randn((F, 3, M, M), generator=gen, **dev)
        Sp = torch.randn((F, 6, M, M), generator=gen, **dev)
        vp = torch.randn((F, 3, M, M), generator=gen, **dev)
        mats = torch.randn((F, 8), generator=gen, **dev).abs() + 0.5
        mats[: F // 3, 3] = 0.0  # acoustic minus side: the k1 = 0 branch
        errs, ms, ms_pair, plain = [], [], [], []
        for face in range(6):
            a = (Sm, vm, Sp, vp, mats, int(FACE_AXIS[face]), float(FACE_SIGN[face]))
            (fe, fv), (fe_r, fv_r) = dg_flux(*a), ref.dg_flux_ref(*a)
            torch.cuda.synchronize()
            errs.append(max(check_close(f"dg_flux FE face {face} {dtype}", fe, fe_r, TOL[dtype]),
                            check_close(f"dg_flux Fv face {face} {dtype}", fv, fv_r, TOL[dtype])))
            ms.append(device_ms(lambda: dg_flux(*a)))
            ms_pair.append(time_ms(lambda: dg_flux(*a)))
            plain.append(time_ms(lambda: ref.dg_flux_ref(*a)))
        # what one launch must move: the traction jump across a face of
        # normal e_axis reads row `axis` of S (3 of 6 stored fields) and v
        # (3) on both sides; it writes FE (6) and Fv (3); plus the table
        n_bytes = ((2 * (3 + 3) + 9) * F * M * M + 8 * F) * Sm.element_size()
        n_flops = F * M * M * 35 + F * 12
        b, by = bound_ms(n_bytes, n_flops, dtype)
        out.setdefault("dg_flux", {})[dtype] = dict(
            max_abs_err=max(errs), ms=statistics.mean(ms), ms_event_pair=statistics.mean(ms_pair),
            plain_ms=statistics.mean(plain), bound_ms=b, bound_by=by)
        del Sm, vm, Sp, vp, mats
        torch.cuda.empty_cache()
    for name, per in out.items():
        for dtype, r in per.items():
            scaled = (f" max_err/(1+scale)={r['max_err_over_scale']:.3e}"
                      if "max_err_over_scale" in r else "")
            log(f"[kernels] {name} {str(dtype).split('.')[-1]}: max_abs_err={r['max_abs_err']:.3e}"
                f"{scaled} (tol {TOL[dtype]:g}) "
                f"kernel={r['ms']:.4f}ms (one launch between its own events: "
                f"{r['ms_event_pair']:.4f}ms) plain={r['plain_ms']:.4f}ms "
                f"bound={r['bound_ms']:.4f}ms ({r['bound_by']})")
    return out


def flash_inputs(gen, dtype, B, Hq, Hkv, S, D):
    dev = dict(device="cuda", dtype=torch.float32)
    return tuple(torch.randn(shape, generator=gen, **dev).to(dtype)
                 for shape in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))


def flash_bound(q, k, causal: bool, window) -> tuple:
    """Least time for one call: the flops of the (q, k) pairs this call's
    mask keeps (2 D for q.k and 2 D for p.v each) at the type's peak, or
    q, k, v and o moved once at the HBM rate."""
    B, Hq, Sq, D = q.shape
    qpos = torch.arange(Sq, device="cuda")[:, None]
    kpos = torch.arange(k.shape[2], device="cuda")[None, :]
    keep = torch.ones((Sq, k.shape[2]), dtype=torch.bool, device="cuda")
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    n_flops = 4 * D * int(keep.sum()) * B * Hq
    n_bytes = 2 * (q.numel() + k.numel()) * q.element_size()
    return (*bound_ms(n_bytes, n_flops, q.dtype), n_flops)


def phase_flash(gen: torch.Generator) -> dict:
    """Phase 6: the flash kernel against its plain version at the serving
    slice's shapes, over the reference kernel test's sweep, and at head dims
    80 and 160 (ragged lengths, GQA 2:1).  At the slice the kernel and
    ``scaled_dot_product_attention`` are timed in turns (kernel, SDPA, SDPA,
    kernel) on the device clock."""
    out = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = flash_inputs(gen, dtype, **SLICE)
        got = flash_attention(q, k, v, causal=True)
        want = ref.flash_attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = check_close(f"flash slice {dtype}", got.float(), want.float(), FLASH_TOL[dtype])
        del got, want
        b, by, n_flops = flash_bound(q, k, True, None)
        kernel = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
        library = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
        turns = [device_ms(f) for f in (kernel, library, library, kernel)]
        ms, library_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        out[dtype] = dict(
            max_abs_err=err, ms=ms, plain_ms=time_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=True)),
            library_ms=library_ms, bound_ms=b, bound_by=by, turns_ms=turns,
            tflops=n_flops / ms / 1e9, bound_share=b / ms, sdpa_ratio=ms / library_ms)
        del q, k, v
        torch.cuda.empty_cache()
    sweep = [(2, 2, 2, S, D, mode) for S, D in ((256, 64), (192, 32), (128, 128))
             for mode in ("causal", "encoder", "swa")]
    sweep += [(2, 4, 2, 200, 80, "causal"), (2, 4, 2, 200, 160, "causal"),
              (1, 4, 2, 96, 160, "swa")]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for B, Hq, Hkv, S, D, mode in sweep:
        kw = dict(causal=(mode != "encoder"), window=(S // 4 if mode == "swa" else None))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(gen, dtype, B, Hq, Hkv, S, D)
            got = flash_attention(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            worst[dtype] = max(worst[dtype], check_close(
                f"flash sweep S={S} D={D} {mode} {dtype}", got.float(), want.float(),
                FLASH_TOL[dtype]))
    for dtype, r in out.items():
        log(f"[flash] slice {SLICE} causal {str(dtype).split('.')[-1]}: "
            f"max_abs_err={r['max_abs_err']:.3e} (tol {FLASH_TOL[dtype]:g}) "
            f"kernel={r['ms']:.4f}ms plain={r['plain_ms']:.4f}ms sdpa={r['library_ms']:.4f}ms "
            f"bound={r['bound_ms']:.4f}ms ({r['bound_by']}); {r['tflops']:.1f} TFLOP/s, "
            f"{r['bound_share'] * 100:.1f}% of the bound, {r['sdpa_ratio']:.3f}x SDPA's time "
            f"(turns kernel/sdpa/sdpa/kernel: {', '.join(f'{t:.4f}' for t in r['turns_ms'])} ms)")
    paths = {D: bf16_tiling(D) for D in HEAD_DIMS}
    log("[flash] bf16 path by head dim: " + "; ".join(
        f"D {D}: {t['path']}, padded to {t['padded_dim']}, tiles {t['block_q']}x{t['block_k']}"
        for D, t in paths.items()))
    out[torch.bfloat16]["paths"] = {str(D): t["path"] for D, t in paths.items()}
    log(f"[flash] sweep of {len(sweep)} shapes x 2 dtypes: max_abs_err "
        f"f32 {worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e}")
    return out


def event_ms(fn) -> float:
    """Milliseconds of one ``fn()`` between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def phase_serve(gen: torch.Generator) -> dict:
    """Phase 7: qwen2-7b at full width through the one-shot serve CLI."""
    t0 = time.perf_counter()
    cfg, lm = build_lm("qwen2-7b", smoke=False, seed=SEED, device="cuda", dtype="bfloat16")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"[serve] built {cfg.arch_id}: L={cfg.n_layers} d={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} hd={cfg.head_dim_} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"{cfg.dtype}, {n_params / 1e9:.3f} G params, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
        f"{time.perf_counter() - t0:.1f}s")
    published = dict(n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
                     d_ff=18944, vocab_size=152064)
    if any(getattr(cfg, f) != v for f, v in published.items()) or lm.plan.padded_q != 28:
        raise AssertionError(f"not the published qwen2-7b widths: {cfg}")
    args = serve_cli.parser().parse_args(SERVE_ARGS)

    reset_counts()
    res = serve_cli.run_oneshot(args, built=(cfg, lm))
    launched = counts()
    kernels, ex = res["kernels"], res["executor"]
    n_prefills = kernels.prefills
    if launched["flash_attention"] != cfg.n_layers * n_prefills or n_prefills == 0:
        raise AssertionError(f"flash launches {launched['flash_attention']} != "
                             f"{cfg.n_layers} x {n_prefills} prefills")
    if res["serve_prefills"] != len([c for c in ex.counts if c > 0]):
        raise AssertionError(f"serve pass prefills {res['serve_prefills']} != partitions")
    gen_tok = res["gen"]
    in_vocab = bool(((gen_tok >= 0) & (gen_tok < cfg.vocab_size)).all())
    if gen_tok.shape != (args.batch, args.gen) or not in_vocab:
        raise AssertionError("tokens outside the logical vocab")

    # the kernel's last-position prefill logits against the plain version's on
    # the same rows; held in check_logits below, against the f32 model
    prompts = res["prompts"]
    offs = ex.offsets
    rows = torch.as_tensor(prompts[offs[0]:offs[1]], dtype=torch.long, device=lm.device)
    auto_bf16 = lm.prefill(rows)[0].float()
    plain_bf16 = lm.with_impl("torch").prefill(rows)[0].float()

    # the flash kernel's share of one sub-batch prefill (CUDA events)
    prefill_ms = statistics.median(event_ms(lambda: lm.prefill(rows)) for _ in range(3))
    q, k, v = flash_inputs(gen, torch.bfloat16, len(rows), cfg.n_heads, cfg.n_kv_heads,
                           prompts.shape[1], cfg.head_dim_)
    flash_ms = device_ms(lambda: flash_attention(q, k, v, causal=True))
    del q, k, v

    # the same rows as one batch: how many greedy tokens agree (printed, not held:
    # cuBLAS may choose other algorithms at other batch sizes)
    whole, _, _ = decode_batch(kernels, prompts, args.gen)
    agree = int((whole == gen_tok).sum())
    out = dict(prefill_ms=res["prefill_s"] * 1e3, decode_ms_per_step=res["decode_ms_per_step"],
               tok_per_s=res["tok_per_s"], counts=ex.counts.tolist(), round=ex.round,
               launches=launched, prefills=n_prefills, sub_batch_prefill_ms=prefill_ms,
               flash_ms_per_layer=flash_ms,
               flash_share=cfg.n_layers * flash_ms / prefill_ms, agree=agree,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[serve] {cfg.arch_id} {cfg.dtype} batch {args.batch} prompt {args.prompt_len} "
        f"gen {args.gen}, {args.partitions} partitions: "
        f"prefill {out['prefill_ms']:.1f} ms (both sub-batches), "
        f"decode {out['decode_ms_per_step']:.2f} ms/step, {out['tok_per_s']:.1f} tok/s, "
        f"calibrated counts {out['counts']} (round {out['round']}), launches {launched} over "
        f"{n_prefills} prefills (calibration, warm-up and serve)")
    log(f"[serve] one prefill of {len(rows)} rows: {prefill_ms:.2f} ms; flash kernel "
        f"{flash_ms:.3f} ms x {cfg.n_layers} layers = {out['flash_share'] * 100:.1f}% of it; "
        f"greedy tokens equal to one batch of the same rows: {agree}/{whole.size}; "
        f"peak {out['peak_gb']:.1f} GB")
    del kernels, res, lm
    torch.cuda.empty_cache()
    out.update(check_logits(rows, auto_bf16, plain_bf16))
    return out


def check_logits(rows: torch.Tensor, auto_bf16: torch.Tensor, plain_bf16: torch.Tensor) -> dict:
    """The flash kernel against its plain version through the whole model.

    bf16 rounding alone moves the logits by more than a kernel fault of a few
    ulps would, so the kernel is held twice, on the same rows and the same
    weights (seed 0, built in float32; the bf16 model is their cast):

    * in float32, kernel vs plain prefill within ``LOGITS_F32_TOL`` of
      max|logits|, the float32 flash tolerance;
    * in bf16, kernel vs plain within ``BF16_NOISE_MULT`` = 2 times the
      measured bf16 noise N = max|plain bf16 - plain float32|.  If the
      kernel's bf16 logits are no further than N from float32, as the plain
      version's are, the triangle inequality puts the two within 2 N."""
    t0 = time.perf_counter()
    cfg, lm = build_lm("qwen2-7b", smoke=False, seed=SEED, device="cuda", dtype="float32")
    auto_f32 = lm.prefill(rows)[0]
    plain_f32 = lm.with_impl("torch").prefill(rows)[0]
    scale = float(plain_f32.abs().max())
    err_f32 = float((auto_f32 - plain_f32).abs().max())
    err_bf16 = float((auto_bf16 - plain_bf16).abs().max())
    noise = float((plain_bf16 - plain_f32).abs().max())
    log(f"[serve] last-position prefill logits of {len(rows)} rows ({cfg.dtype} model built in "
        f"{time.perf_counter() - t0:.1f}s), max|logits| {scale:.4e}: float32 kernel vs plain "
        f"{err_f32:.4e} ({err_f32 / scale:.3e} of max, tol {LOGITS_F32_TOL:g}); bf16 kernel vs "
        f"plain {err_bf16:.4e}, bf16 noise |plain bf16 - plain float32| {noise:.4e} "
        f"({noise / scale:.3e} of max), kernel/noise {err_bf16 / noise:.3f} "
        f"(tol {BF16_NOISE_MULT:g})")
    if not np.isfinite([scale, err_f32]).all() or err_f32 > LOGITS_F32_TOL * scale:
        raise AssertionError(f"float32 prefill logits: {err_f32:.3e} > "
                             f"{LOGITS_F32_TOL:g} * {scale:.3e}")
    if not np.isfinite([noise, err_bf16]).all() or err_bf16 > BF16_NOISE_MULT * noise:
        raise AssertionError(f"bf16 prefill logits: {err_bf16:.3e} > "
                             f"{BF16_NOISE_MULT:g} * bf16 noise {noise:.3e}")
    del lm
    torch.cuda.empty_cache()
    return dict(logit_scale=scale, logit_err_f32=err_f32, logit_err_bf16=err_bf16,
                logit_noise_bf16=noise)


def reset_counts() -> None:
    dg_volume.launches = 0
    dg_flux.launches = 0
    flash_attention.launches = 0


def counts() -> dict:
    return {"dg_volume": dg_volume.launches, "dg_flux": dg_flux.launches,
            "flash_attention": flash_attention.launches}


def timed_run(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / STEPS * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    build.library()
    log(f"[build] {time.perf_counter() - t0:.1f}s -> {build.library_path().name}")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("== "):
            log(f"[build] {line.strip()}")
    hgmma = sass_count("HGMMA")
    log(f"[build] HGMMA (wgmma) instructions in the bf16 flash kernels by head dim: {hgmma}")
    if sorted(hgmma) != sorted(HEAD_DIMS) or min(hgmma.values()) == 0:
        raise AssertionError(f"a bf16 flash kernel does not run on the tensor cores: {hgmma}")

    solver = make_two_tree_solver(grid=CONFIG.grid, order=CONFIG.order, extent=EXTENT,
                                  cp=CONFIG.cp, cs=CONFIG.cs, rho=CONFIG.rho,
                                  dtype="float64", kernel_impl="auto", device="cuda")

    # 3. kernels vs plain versions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kern = phase_kernels(gen, solver)

    # 4. the flat solver at full width
    plain_solver = dataclasses.replace(solver, kernel_impl="torch")
    q0 = gaussian_pulse(solver, center=(EXTENT[0] / 2, 0.5, 0.5), device="cuda")
    dt = solver.cfl_dt()
    solver.run(q0, 1, dt)  # warm up: the first full-width step grows PyTorch's allocator
    plain_solver.run(q0, 1, dt)
    reset_counts()
    q_flat, ms_flat = timed_run(lambda: solver.run(q0, STEPS, dt))
    flat_counts = counts()
    q_plain, ms_plain = timed_run(lambda: plain_solver.run(q0, STEPS, dt))
    qmax = float(q_flat.abs().max())
    diff = float((q_flat - q_plain).abs().max())
    e0, e1 = solver.energy(q0), solver.energy(q_flat)
    log(f"[flat] K={solver.mesh.K} order={solver.order} dt={dt:.6e} steps={STEPS}: "
        f"kernels {ms_flat:.3f} ms/step, plain {ms_plain:.3f} ms/step, "
        f"max|kernels-plain|={diff:.3e} (max|q|={qmax:.3e}), energy {e0:.12e} -> {e1:.12e}, "
        f"launches {flat_counts}")
    if not np.isfinite(qmax) or diff > 1e-10 * qmax:
        raise AssertionError(f"flat kernels vs plain: {diff:.3e} > 1e-10 * {qmax:.3e}")
    if not (np.isfinite(e1) and e1 <= e0 * 1.0001):
        raise AssertionError(f"energy grew: {e0} -> {e1}")
    if min(flat_counts["dg_volume"], flat_counts["dg_flux"]) <= 0:
        raise AssertionError(f"the flat run launched no kernel: {flat_counts}")
    del q_plain

    # 5. the nested partition at full width
    K = solver.mesh.K
    ex = NestedPartitionExecutor(K, 4, grid_dims=CONFIG.grid, bucket=16, rebalance_every=5)
    eng = BlockedDGEngine(solver, ex)
    report = eng.calibrate(q0)
    log("[nested] calibration:\n" + report.summary())
    counts_before = ex.counts.tolist()
    reset_counts()
    q_nested, ms_nested = timed_run(lambda: eng.run(q0, STEPS, dt=dt, observe=True))
    nested_counts = counts()
    stats = eng.pipeline().stats
    diff_n = float((q_nested - q_flat).abs().max())
    log(f"[nested] P=4 bucket=16 rebalance_every=5: counts {counts_before} -> {ex.counts.tolist()}, "
        f"{ms_nested:.3f} ms/step, max|nested-flat|={diff_n:.3e}, launches {nested_counts}, "
        f"ledger {stats.kernel_launches} observe_chunks={stats.observe_chunks} round={ex.round}")
    if diff_n > 1e-12 * qmax:
        raise AssertionError(f"nested vs flat: {diff_n:.3e} > 1e-12 * {qmax:.3e}")
    if stats.kernel_launches != {"volume": 1, "surface": 1}:
        raise AssertionError(f"envelope ledger {stats.kernel_launches}")
    if stats.observe_chunks != STEPS // 5:
        raise AssertionError(f"observe_chunks {stats.observe_chunks} != {STEPS // 5}")
    if nested_counts["dg_volume"] < 5 * STEPS or nested_counts["dg_flux"] <= 0:
        raise AssertionError(f"the nested run did not go through the kernels: {nested_counts}")

    del q_nested, q_flat, eng, solver, plain_solver
    torch.cuda.empty_cache()

    # 6. the flash kernel vs its plain version
    flash = phase_flash(gen)

    # 7. qwen2-7b one-shot serving at full width
    serve = phase_serve(gen)

    # the kernels line, then the card, then the result
    sources = {"dg_volume": ("src/repro_torch/csrc/dg_volume.cu", "src/repro/kernels/dg_volume.py:129"),
               "dg_flux": ("src/repro_torch/csrc/dg_flux.cu", "src/repro/kernels/dg_flux.py:98")}
    rows = []
    for name, per in kern.items():
        main_row = per[torch.float64]
        rows.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": nested_counts[name],
            "launches_flat": flat_counts[name], "dtype": "float64",
            **main_row, "kernel_ms": main_row["ms"], "library_ms": None,
            "float32": per[torch.float32],
        })
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:91",
        "launches": serve["launches"]["flash_attention"], "dtype": "bfloat16",
        "shape": SLICE, **flash[torch.bfloat16], "kernel_ms": flash[torch.bfloat16]["ms"],
        "hgmma_by_head_dim": {str(D): n for D, n in hgmma.items()},
        "float32": flash[torch.float32],
    })
    log(json.dumps({"kernels": rows}))
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
