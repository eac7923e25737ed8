"""Device timing on CUDA events.

Port of ``ntt_aie_tpu.utils.timing.time_device``: a dependent chain (each
call consumes the previous output, so no work can be skipped) of `iters`
calls, timed between two CUDA events, `repeats` times, reduced with the
reference's trimmed mean (drop the min and the max). PyTorch returns
before the device finishes, so the events, not a host clock, bound the
work. There is no CPU route: a time is only taken on a CUDA device.
"""

from __future__ import annotations

import numpy as np
import torch


def time_device(fn, x: torch.Tensor | tuple, *, iters: int = 10,
                repeats: int = 5) -> dict:
    """Time fn on x's CUDA device. x is a tensor or a tuple of tensors
    (the Goldilocks (hi, lo) planes). fn's output must be a valid input
    (true for the n1 == n2 matrix-form transforms). Returns
    dict(us_per_iter, best_us, runs_us, result)."""
    device = (x[0] if isinstance(x, tuple) else x).device
    if device.type != "cuda":
        raise RuntimeError(f"time_device measures a CUDA device, got a "
                           f"tensor on {device}")

    def run(y):
        for _ in range(iters):
            y = fn(y)
        return y

    out = run(x)  # warm-up: builds and loads the kernel on first use
    torch.cuda.synchronize(device)
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(x)
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) * 1e3 / iters)
    runs_sorted = sorted(runs)
    trimmed = runs_sorted[1:-1] if len(runs_sorted) > 2 else runs_sorted
    return {
        "us_per_iter": float(np.mean(trimmed)),
        "best_us": runs_sorted[0],
        "runs_us": runs,
        "result": out,
    }
