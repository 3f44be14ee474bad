"""The bf16 flash kernel beside ``scaled_dot_product_attention`` at a few
shapes of qwen2-7b's attention (Hq 28, Hkv 4, D 128): the serving slice
(2 rows of 2048, causal), the same without the mask, one row of 8192 with
and without the mask, and 128 queries against 8192 keys (fewer blocks than
SMs).

    python -m repro_torch.launch.bench_flash

Prints one JSON line per shape: device ms of the kernel and of SDPA, timed
in turns (kernel, SDPA, SDPA, kernel), each the mean of calls queued behind
a spin kernel; the TFLOP/s of the unmasked pairs (4 D flops each); the
kernel's max abs error against SDPA.  SDPA is a yardstick only: the port
never calls it.  Needs a CUDA device.
"""

from __future__ import annotations

import json

import torch

from repro_torch.kernels.flash_attention import flash_attention

REPS = 20
SPIN_CYCLES = 50_000_000  # torch.cuda._sleep ahead of queued calls: ~25 ms at 1.98 GHz
# (name, B, Sq, Skv, causal)
SHAPES = [("slice causal", 2, 2048, 2048, True), ("slice unmasked", 2, 2048, 2048, False),
          ("8192 causal", 1, 8192, 8192, True), ("8192 unmasked", 1, 8192, 8192, False),
          ("128 x 8192 unmasked", 2, 128, 8192, False)]
HQ, HKV, D = 28, 4, 128


def device_ms(fn, reps: int = REPS) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls queued behind
    a spin kernel, between one pair of CUDA events, after one warmup."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash needs a CUDA device")
    print(torch.cuda.get_device_name(0), flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, B, Sq, Skv, causal in SHAPES:
        q, k, v = (torch.randn(s, generator=gen, device="cuda").bfloat16()
                   for s in ((B, HQ, Sq, D), (B, HKV, Skv, D), (B, HKV, Skv, D)))
        kernel = lambda: flash_attention(q, k, v, causal=causal)  # noqa: E731
        library = lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)  # noqa: E731
        err = float((kernel().float() - library().float()).abs().max())
        turns = [device_ms(f) for f in (kernel, library, library, kernel)]
        ms, sdpa_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        pairs = B * HQ * (Sq * (Sq + 1) // 2 if causal else Sq * Skv)
        print(json.dumps({"shape": name, "B": B, "Hq": HQ, "Hkv": HKV, "Sq": Sq, "Skv": Skv,
                          "D": D, "causal": causal, "ms": ms, "sdpa_ms": sdpa_ms,
                          "tflops": 4 * D * pairs / ms / 1e9,
                          "sdpa_tflops": 4 * D * pairs / sdpa_ms / 1e9,
                          "ratio_to_sdpa": ms / sdpa_ms, "max_abs_err_vs_sdpa": err,
                          "turns_ms": turns}), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
