"""Where a full-width DG step goes on the card: ``torch.profiler`` over a few
steps of the flat solver and of the nested-partition engine (``dg-paper``:
32x16x16, order 7, float64).

    python -m repro_torch.launch.profile_dg [--out DIR]

For each path it prints ms/step (host clock, device synchronized, no
profiler), the device busy share of a profiled window (summed device time
of all kernels / wall), and the kernels taking the most device time; the
Chrome traces go to ``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs.dg_wave import CONFIG
from repro_torch.dg.solver import gaussian_pulse, make_two_tree_solver
from repro_torch.runtime.executor import BlockedDGEngine, NestedPartitionExecutor

EXTENT = (2.0, 1.0, 1.0)
STEPS = 5  # profiled steps per path, after one warmup step
TOP = 15  # kernels listed per path


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(name: str, fn, out_dir: str, steps: int = STEPS, top: int = TOP) -> dict:
    """ms/step of ``fn(steps)`` unprofiled, then one profiled window: the
    device busy share (kernel, copy and memset time on the device over the
    window's wall time; the profiler's host overhead makes it a lower
    bound) and the kernels that take the most device time."""
    fn(1)  # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(steps)
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) / steps * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    busy_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops: their kernels are counted as device events
        us = _device_us(evt)
        busy_us += us
        rows.append((us, evt.key, evt.count))
    rows.sort(reverse=True)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
    summary = {
        "path": name, "steps": steps, "ms_per_step": ms_per_step,
        "profiled_ms_per_step": wall / steps * 1e3,
        "device_ms_per_step": busy_us / steps * 1e-3,
        "device_busy_share": busy_us * 1e-6 / wall,
        "top": [{"name": k[:90], "device_ms_per_step": us / steps * 1e-3, "calls": c}
                for us, k, c in rows[:top]],
    }
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile_dg")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_dg needs a CUDA device")
    solver = make_two_tree_solver(grid=CONFIG.grid, order=CONFIG.order, extent=EXTENT,
                                  cp=CONFIG.cp, cs=CONFIG.cs, rho=CONFIG.rho, device="cuda")
    q0 = gaussian_pulse(solver, center=(EXTENT[0] / 2, 0.5, 0.5), device="cuda")
    dt = solver.cfl_dt()
    ex = NestedPartitionExecutor(solver.mesh.K, 4, grid_dims=CONFIG.grid, bucket=16,
                                 rebalance_every=5)
    eng = BlockedDGEngine(solver, ex)
    print(torch.cuda.get_device_name(0), flush=True)
    profile("flat", lambda n: solver.run(q0, n, dt), args.out)
    profile("nested", lambda n: eng.run(q0, n, dt=dt), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
