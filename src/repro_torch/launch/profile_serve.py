"""Where one-shot serving of ``qwen2-7b`` goes on the card:
``torch.profiler`` over prefills of one sub-batch (2 rows of 2048 tokens)
and over greedy decode steps of it, at the published widths in bf16 with
weights from seed 0.

    python -m repro_torch.launch.profile_serve [--out DIR]

For each phase it prints ms per call (host clock, device synchronized, no
profiler), the device busy share of a profiled window and the kernels
taking the most device time (``profile_dg.profile``); the Chrome traces go
to ``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.data.pipeline import _rng
from repro_torch.launch.profile_dg import profile
from repro_torch.runtime.serving import ServeKernels, build_lm

ROWS, PROMPT = 2, 2048  # one sub-batch of the chip_smoke.py serve
PREFILLS, DECODE_STEPS = 3, 8  # profiled calls per phase, after one warmup


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile_serve")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, lm = build_lm("qwen2-7b", smoke=False, seed=0, device="cuda", dtype="bfloat16")
    prompts = _rng(0, 0).integers(0, cfg.vocab_size, (ROWS, PROMPT), dtype=np.int32)
    kernels = ServeKernels(lm, max_len=PROMPT + DECODE_STEPS + 8)
    print(torch.cuda.get_device_name(0), flush=True)

    def prefills(n):
        for _ in range(n):
            tok, cache = kernels.prefill_rows(prompts)
        return tok, cache

    profile("prefill", prefills, args.out, steps=PREFILLS)
    tok, cache = prefills(1)
    # every call decodes from the prompt's end again (the cache is written in place)
    profile("decode", lambda n: kernels.decode_scan(cache, tok, n), args.out, steps=DECODE_STEPS)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
