#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero):

1. device  — the card's name and power limit; TF32 off;
2. build   — nvcc builds ``src/repro_torch/csrc/*.cu`` (one process per
             source, started together) into ``src/repro_torch/_build/``;
3. kernels — ``dg_volume`` and ``dg_flux`` against their plain PyTorch
             versions at the ``dg-paper`` shapes (K = F = 8192, order 7) and,
             for the volume kernel, the solver's own metrics and materials,
             in float64 and float32, timed with CUDA events;
4. flat    — ``make_two_tree_solver`` at full width (32x16x16, order 7,
             float64) for 20 steps with the kernels and with the plain
             versions; they must agree and energy must not grow;
5. nested  — ``NestedPartitionExecutor`` (4 partitions) + ``BlockedDGEngine``:
             ``calibrate`` then ``run(q0, 20, observe=True)``, which must
             reproduce phase 4 and go through both kernels.

Prints one ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits 1 and prints no result.  It imports nothing of JAX.
"""

import dataclasses
import json
import os
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
from repro_torch.runtime.executor import BlockedDGEngine, NestedPartitionExecutor  # noqa: E402

SEED = 0
STEPS = 20
EXTENT = (2.0, 1.0, 1.0)
TOL = {torch.float64: 1e-11, torch.float32: 5e-4}  # tests/test_kernels.py:_tol
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}  # non-tensor-core peaks
TIMING_REPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` launches, each between
    its own pair of CUDA events, after one warmup."""
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
            max_abs_err=err, max_err_over_scale=rel, ms=time_ms(lambda: dg_volume(*args)),
            plain_ms=time_ms(lambda: ref.dg_volume_ref(*args)), bound_ms=b, bound_by=by)
        del q, args

        F = K
        Sm = torch.randn((F, 6, M, M), generator=gen, **dev)
        vm = torch.randn((F, 3, M, M), generator=gen, **dev)
        Sp = torch.randn((F, 6, M, M), generator=gen, **dev)
        vp = torch.randn((F, 3, M, M), generator=gen, **dev)
        mats = torch.randn((F, 8), generator=gen, **dev).abs() + 0.5
        mats[: F // 3, 3] = 0.0  # acoustic minus side: the k1 = 0 branch
        errs, ms, plain = [], [], []
        for face in range(6):
            a = (Sm, vm, Sp, vp, mats, int(FACE_AXIS[face]), float(FACE_SIGN[face]))
            (fe, fv), (fe_r, fv_r) = dg_flux(*a), ref.dg_flux_ref(*a)
            torch.cuda.synchronize()
            errs.append(max(check_close(f"dg_flux FE face {face} {dtype}", fe, fe_r, TOL[dtype]),
                            check_close(f"dg_flux Fv face {face} {dtype}", fv, fv_r, TOL[dtype])))
            ms.append(time_ms(lambda: dg_flux(*a)))
            plain.append(time_ms(lambda: ref.dg_flux_ref(*a)))
        # what one launch must move: the traction jump across a face of
        # normal e_axis reads row `axis` of S (3 of 6 stored fields) and v
        # (3) on both sides; it writes FE (6) and Fv (3); plus the table
        n_bytes = ((2 * (3 + 3) + 9) * F * M * M + 8 * F) * Sm.element_size()
        n_flops = F * M * M * 35 + F * 12
        b, by = bound_ms(n_bytes, n_flops, dtype)
        out.setdefault("dg_flux", {})[dtype] = dict(
            max_abs_err=max(errs), ms=statistics.mean(ms), plain_ms=statistics.mean(plain),
            bound_ms=b, bound_by=by)
        del Sm, vm, Sp, vp, mats
        torch.cuda.empty_cache()
    for name, per in out.items():
        for dtype, r in per.items():
            scaled = (f" max_err/(1+scale)={r['max_err_over_scale']:.3e}"
                      if "max_err_over_scale" in r else "")
            log(f"[kernels] {name} {str(dtype).split('.')[-1]}: max_abs_err={r['max_abs_err']:.3e}"
                f"{scaled} (tol {TOL[dtype]:g}) "
                f"kernel={r['ms']:.4f}ms plain={r['plain_ms']:.4f}ms "
                f"bound={r['bound_ms']:.4f}ms ({r['bound_by']})")
    return out


def reset_counts() -> None:
    dg_volume.launches = 0
    dg_flux.launches = 0


def counts() -> dict:
    return {"dg_volume": dg_volume.launches, "dg_flux": dg_flux.launches}


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
    if min(flat_counts.values()) <= 0:
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
    log(json.dumps({"kernels": rows}))
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
