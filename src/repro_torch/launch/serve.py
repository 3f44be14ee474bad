"""One-shot serving CLI over ``repro_torch.runtime.serving``.

Prefill a prompt batch, decode ``--gen`` greedy tokens, report latency and
throughput.  With ``--partitions P`` the batch is split across P partitions
by a ``NestedPartitionExecutor``: a calibration pass times each partition's
prefill (boundary phase) and decode (interior phase) into a
``CalibrationReport``, the executor re-solves the row split
(``plan_from_report``), and the serving pass uses the calibrated counts.
Decode is an eager loop: one dispatch per step and sub-batch.

Runs on the card unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --smoke \\
      --device cpu --batch 4 --prompt-len 32 --gen 8 --partitions 2
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np

from repro_torch.data.pipeline import _rng
from repro_torch.runtime.executor import NestedPartitionExecutor
from repro_torch.runtime.serving import (
    ServeKernels,
    build_lm,
    calibrate_split,
    decode_batch,
    warm_batch,
)


def run_oneshot(args, built=None) -> dict:
    """The one-shot serve of ``args``; ``built`` is an optional ``(cfg, lm)``
    from ``build_lm`` to serve instead of building one.  Prints the summary
    and returns what it measured."""
    cfg, lm = built or build_lm(args.arch, smoke=args.smoke, seed=args.seed,
                                device=args.device, dtype=args.dtype)
    g = _rng(args.seed, 0)
    prompts = g.integers(0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    kernels = ServeKernels(lm, max_len=args.prompt_len + args.gen + 8)

    P = max(1, min(args.partitions, args.batch))
    report = None
    if P > 1:
        executor, report = calibrate_split(kernels, prompts, P, calib_gen=args.calib_gen)
        print("calibration report:")
        print(report.summary())
        print(f"calibrated split: counts={executor.counts.tolist()} "
              f"(round {executor.round}, predicted makespan "
              f"{executor.predicted_makespan() * 1e3:.1f}ms)")
    else:
        executor = NestedPartitionExecutor(args.batch, P, bucket=1, smoothing=1.0)

    # serving pass on the calibrated split; the contiguous split keeps the
    # row order under concatenation.  Warm every sub-batch shape first.
    offs = executor.offsets
    for p in range(P):
        warm_batch(kernels, prompts[offs[p]:offs[p + 1]], args.gen)
    prefills_before = kernels.prefills
    parts, per_part = [], []
    t_prefill_all, t_decode_all = 0.0, 0.0
    for p in range(P):
        rows = prompts[offs[p]:offs[p + 1]]
        if len(rows) == 0:
            continue
        gen_p, tp, td = decode_batch(kernels, rows, args.gen)
        parts.append(gen_p)
        per_part.append((p, int(len(rows)), tp, td))
        t_prefill_all += tp
        t_decode_all += td
    gen = np.concatenate(parts, axis=0)

    assert gen.shape == (args.batch, args.gen)
    assert (gen >= 0).all() and (gen < cfg.vocab_size).all()
    per_tok = t_decode_all / max(1, args.gen - 1)
    print(f"arch={cfg.arch_id} batch={args.batch} partitions={P} "
          f"prefill({args.prompt_len} tok)={t_prefill_all * 1e3:.1f}ms "
          f"decode={per_tok * 1e3:.2f} ms/step throughput={args.batch / per_tok:.1f} tok/s "
          f"decode-dispatches/sub-batch={args.gen - 1} (eager loop)")
    for p, n, tp, td in per_part:
        print(f"  partition {p}: rows={n} wall={(tp + td) * 1e3:.1f}ms")
    print("sample:", gen[0, :16].tolist())
    if args.out:
        np.save(args.out, gen)
        print(f"wrote {args.out}")
    return {
        "cfg": cfg, "lm": lm, "kernels": kernels, "prompts": prompts, "gen": gen,
        "executor": executor, "report": report, "prefill_s": t_prefill_all,
        "decode_s": t_decode_all, "decode_ms_per_step": per_tok * 1e3,
        "tok_per_s": args.batch / per_tok, "serve_prefills": kernels.prefills - prefills_before,
        "per_partition": per_part,
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", help="model arch id (see --list-scenarios)")
    ap.add_argument("--list-scenarios", action="store_true",
                    help="print every registered arch and exit")
    ap.add_argument("--smoke", action="store_true", help="the reduced CPU-test config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--partitions", type=int, default=1,
                    help="partitions the request batch is split over")
    ap.add_argument("--calib-gen", type=int, default=4,
                    help="decode steps per partition in the calibration pass")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the generated (batch, gen) token matrix as .npy")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--dtype", default=None,
                    help="activation dtype, e.g. bfloat16 or float32 (default: the config's)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.list_scenarios:
        from repro_torch.configs.registry import format_listing

        print(format_listing())
        return 0
    if not args.arch:
        ap.error("--arch is required (or --list-scenarios to enumerate)")
    run_oneshot(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
