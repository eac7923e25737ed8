"""Device timing: CUDA events on the card, the host clock on the CPU.

Port of ``ntt_aie_tpu.utils.timing``. ``time_device`` times a dependent
chain (each call consumes the previous output, so no work can be skipped)
of `iters` calls, `repeats` times, reduced with the reference's trimmed
mean (drop the min and the max). The clock follows the device of the
input the caller passes:

- a CUDA tensor is timed between two CUDA events (PyTorch returns before
  the device finishes, so the events, not a host clock, bound the work);
- a CPU tensor, which the caller put there on purpose, is timed with
  ``time.perf_counter`` around the same chain: the plain PyTorch route's
  time, never a device metric.

The result says which (``"clock": "cuda_events"`` or ``"host"``).
``time_host_dispatch`` is the reference's other metric: the wall clock
around one call and its synchronize, the latency a B = 1 caller sees.
``time_graph`` times the card alone: calls captured in one CUDA graph and
replayed, without the host's cost of each launch, cycling over copies of
the inputs so that they can come cold from device memory.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _device_of(x) -> torch.device:
    return (x[0] if isinstance(x, tuple) else x).device


def trimmed_mean(runs: list) -> float:
    """The reference's trimmed mean (plot_exectime.py:27-29): drop the min
    and the max of more than two runs."""
    runs_sorted = sorted(runs)
    trimmed = runs_sorted[1:-1] if len(runs_sorted) > 2 else runs_sorted
    return float(np.mean(trimmed))


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_device(fn, x: torch.Tensor | tuple, *, iters: int = 10,
                repeats: int = 5) -> dict:
    """Time fn on x's device. x is a tensor or a tuple of tensors (the
    Goldilocks (hi, lo) planes). fn's output must be a valid input (true
    for the n1 == n2 matrix-form transforms). A CUDA tensor is timed on
    CUDA events, a CPU tensor on the host clock. Returns dict(us_per_iter,
    best_us, runs_us, result, clock)."""
    device = _device_of(x)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"time_device times a CUDA or CPU tensor, got one "
                         f"on {device}")

    def run(y):
        for _ in range(iters):
            y = fn(y)
        return y

    out = run(x)  # warm-up: builds and loads the kernel on first use
    synchronize(device)
    runs = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run(x)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) * 1e3 / iters)
        else:
            t0 = time.perf_counter()
            out = run(x)
            runs.append((time.perf_counter() - t0) * 1e6 / iters)
    return {
        "us_per_iter": trimmed_mean(runs),
        "best_us": min(runs),
        "runs_us": runs,
        "result": out,
        "clock": "cuda_events" if device.type == "cuda" else "host",
    }


def time_host_dispatch(fn, x, *, runs: int = 10) -> dict:
    """The reference's host E2E metric (src/test.cpp:157-175): the wall
    clock around one call of fn(x) and, for a CUDA input, the
    ``torch.cuda.synchronize`` that waits for it, `runs` times after one
    warm-up call, reduced with the trimmed mean. On the card this is the
    latency one caller sees: the host's enqueue, the launches and the
    device time together. Returns dict(us_trimmed_mean, runs_us)."""
    device = _device_of(x)
    fn(x)
    synchronize(device)
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn(x)
        synchronize(device)
        ts.append((time.perf_counter() - t0) * 1e6)
    return {"us_trimmed_mean": trimmed_mean(ts), "runs_us": ts}


def time_graph(fn, inputs: list, *, repeats: int = 5) -> float:
    """us per call of fn(v) on the card alone: one CUDA graph of
    max(20, len(inputs)) calls cycling over `inputs`, replayed between
    CUDA events `repeats` times, trimmed mean. Copies whose traffic exceeds
    the card's L2 between two uses of one copy are read cold from device
    memory; a single input is read from L2 after the first call."""
    chain = max(20, len(inputs))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(inputs[0])  # a kernel's first call builds it: outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(chain):
            fn(inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) * 1e3 / chain)
    return trimmed_mean(runs)
