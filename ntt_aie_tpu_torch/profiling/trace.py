"""Trace capture on torch.profiler.

Port of ``ntt_aie_tpu/profiling/trace.py``. The reference records its
kernels under ``jax.profiler`` and reads the device rows of the Chrome
trace back; here ``torch.profiler`` (CUPTI on the card) does both:

- ``kernel_markers`` — ``torch.profiler.record_function``: brackets a
  region so its ops group under one label in the trace viewer (the
  reference's ``jax.named_scope``);
- ``capture_trace`` — runs a callable under the profiler (CPU and, when
  its arguments live on the card, CUDA activity), synchronizes inside the
  profiled region and exports a Chrome trace into a directory;
- ``find_chrome_trace`` — the newest exported trace there: a plain
  ``*.trace.json`` file, as ``capture_trace`` writes it (torch writes
  uncompressed JSON unless the name ends in ``.gz``);
- ``summarize_trace`` — per-op device time from that trace: the events
  torch marks as device work, which are CUDA kernels (``"cat": "kernel"``)
  and the copies and fills of device memory (``"gpu_memcpy"``,
  ``"gpu_memset"``), summed by name, largest first, with the timestamp of
  each name's first event (``first_ts``, microseconds on the trace's
  clock) so that callers can put the rows in program order;
- ``device_busy`` — the traced window against the union of its device
  events: the card's busy share over a profiled call;
- ``marker_pair_times`` — per-label rows from ``utils.timing.time_device``
  where a trace has no device events (the plain route on the CPU).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import tempfile
import time
from typing import Callable, Optional

import torch

# the Chrome-trace categories torch gives device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def kernel_markers(label: str):
    """A named marker pair bracketing a region (the reference's
    event0/event1 analog, ``jax.named_scope`` there)."""
    with torch.profiler.record_function(label):
        yield


def _tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _tensors(v)]
    return []


def _synchronize(args) -> None:
    for dev in {t.device for t in _tensors(args) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def capture_trace(fn: Callable, *args, trace_dir: Optional[str] = None,
                  warmup: bool = True) -> str:
    """Run ``fn(*args)`` under torch.profiler and return the directory
    holding its Chrome trace (``<trace_dir>/ntt_<ns>.trace.json``; a new
    temporary directory when trace_dir is None).

    The profiler records CPU activity, and CUDA activity when an argument
    lies on the card. The devices of the arguments are synchronized inside
    the profiled region, so the trace holds the device's execution and not
    just the enqueue. warmup=True runs fn once before profiling (a kernel's
    first call builds it with nvcc, which must stay out of the trace) and
    once more in the profiler's warm-up step, whose events are dropped: the
    tracer's own start-up (CUPTI's first activity buffers, about a
    millisecond on the first launch) stays out of the recorded window.
    """
    from torch.profiler import ProfilerActivity, profile, schedule

    trace_dir = trace_dir or tempfile.mkdtemp(prefix="ntt_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    on_card = any(t.device.type == "cuda" for t in _tensors(args))
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(trace_dir, f"ntt_{time.time_ns()}.trace.json")
    if not warmup:
        with profile(activities=activities) as prof:
            fn(*args)
            _synchronize(args)
        prof.export_chrome_trace(path)
        return trace_dir
    fn(*args)
    _synchronize(args)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for _ in range(2):  # the warm-up step, then the recorded one
            fn(*args)
            _synchronize(args)
            prof.step()
    return trace_dir


def find_chrome_trace(trace_dir: str) -> Optional[str]:
    """The newest ``*.trace.json`` under trace_dir, or None."""
    hits = glob.glob(os.path.join(trace_dir, "**", "*.trace.json"),
                     recursive=True)
    return max(hits, key=os.path.getmtime) if hits else None


def _events(trace_dir: str) -> Optional[list]:
    path = find_chrome_trace(trace_dir)
    if path is None:
        return None
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def _device_events(events: list) -> list:
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def summarize_trace(trace_dir: str, top: int = 20) -> list[dict]:
    """Per-op device time of a captured trace: [{"op", "total_us",
    "count", "first_ts"}], largest total first, over the device events
    (DEVICE_CATEGORIES: kernels, memcpy and memset). Returns [] when there
    is no trace or it holds no device event (a CPU run)."""
    events = _events(trace_dir)
    if events is None:
        return []
    totals: dict[str, list] = {}
    for e in _device_events(events):
        rec = totals.setdefault(e["name"], [0.0, 0, float(e["ts"])])
        rec[0] += float(e.get("dur", 0.0))
        rec[1] += 1
        rec[2] = min(rec[2], float(e["ts"]))
    out = [
        {"op": k, "total_us": v[0], "count": v[1], "first_ts": v[2]}
        for k, v in sorted(totals.items(), key=lambda kv: -kv[1][0])
    ]
    return out[:top]


def device_busy(trace_dir: str) -> dict:
    """The card's busy share over a captured trace: window_us, from the
    first event's start to the last event's end (every timed event but the
    profiler's own span); device_us, the union of the device events'
    intervals (overlapping kernels count once); kernel_sum_us, their plain
    sum; busy_share = device_us / window_us. Zeros when the trace holds no
    device event."""
    events = _events(trace_dir) or []
    timed = [e for e in events
             if e.get("ph") == "X" and e.get("cat") != "Trace"
             and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in _device_events(events))
    window = (max(float(e["ts"]) + float(e["dur"]) for e in timed)
              - min(float(e["ts"]) for e in timed)) if timed else 0.0
    union, end = 0.0, float("-inf")
    for s, t in dev:
        if t > end:
            union += t - max(s, end)
            end = t
    return {"window_us": window, "device_us": union,
            "kernel_sum_us": sum(t - s for s, t in dev),
            "device_events": len(dev),
            "busy_share": union / window if window else 0.0}


def marker_pair_times(fns: dict, *, iters: int = 20,
                      repeats: int = 3) -> list[dict]:
    """Per-label times where the trace shows no device execution:
    dependent chains timed by ``utils.timing.time_device`` (CUDA events on
    the card, the host clock for CPU inputs), in summarize_trace's rows.

    fns: {label: (callable, example_input)} with shape-preserving
    callables. Returns [{"op", "us_per_call", "total_us", "count",
    "clock"}]."""
    from ntt_aie_tpu_torch.utils.timing import time_device

    rows = []
    for label, (fn, x) in fns.items():
        res = time_device(fn, x, iters=iters, repeats=repeats)
        rows.append({
            "op": label,
            "us_per_call": res["us_per_iter"],
            "total_us": res["us_per_iter"] * iters,
            "count": iters,
            "clock": res["clock"],
        })
    return rows
