"""Host <-> device streaming pipeline.

Port of ``ntt_aie_tpu/utils/streaming.py``, the analog of the reference
device's depth-2 FIFOs (reference src/aie2.py:28,331-337): while the card
computes batch k, the copy engines upload k+1 and download k-1.

On the card each batch goes through three streams:

- upload: the host batch is staged in pinned memory and copied with
  ``non_blocking=True`` on a copy stream of its own, which records an
  event;
- compute: the caller's current stream (where the kernels launch,
  ``torch.cuda.current_stream``) waits on that event and runs fn;
- download (to_host=True): a second copy stream waits on compute's event
  and copies the result into pinned host memory; an event synchronize on
  that copy comes before the result is yielded. With to_host=False the
  device result is yielded as it is: work the caller issues on the
  current stream is ordered after it.

Each device buffer is marked with ``Tensor.record_stream`` for the stream
that uses it after the one that made it (the input for compute, the
output for the download), so the caching allocator never hands it to
another allocation while that use is pending. Nothing else synchronizes:
the host blocks only on the oldest batch's download.

On the CPU (device="cpu") fn is applied to each batch in order.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ntt_aie_tpu_torch.utils.device import resolve_device


def _as_words(x) -> torch.Tensor:
    """A host batch as an int32 tensor holding its 32-bit words: a tensor
    as it is (int32), an array of uint32 or int32 viewed, other integer
    arrays (values in [0, 2^32)) narrowed."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:  # torch wraps only writable arrays
        a = a.copy()
    if a.dtype.kind not in "iu":
        raise TypeError(f"a batch holds integers, got {a.dtype}")
    if a.dtype.itemsize != 4:
        if a.size and (a.min() < 0 or a.max() >= 1 << 32):
            raise ValueError("a batch holds 32-bit words")
        a = a.astype(np.uint32)
    return torch.from_numpy(a.view(np.int32))


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU result as NumPy: int32 words as uint32, as the reference's
    uint32 arrays."""
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _planes(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _unplanes(planes: tuple, like):
    return planes if isinstance(like, tuple) else planes[0]


def stream_transform(fn: Callable, inputs: Iterable, *, prefetch: int = 2,
                     to_host: bool = True, device=None) -> Iterator:
    """Yield fn(batch) for each input batch, in order, keeping at most
    `prefetch` batches in flight (uploaded and launched before the oldest
    result is drained).

    fn: a device callable (e.g. plan.make_batched(B)['fwd']).
    inputs: host batches: integer arrays (or CPU tensors) of 32-bit
    words, or (hi, lo) tuples of them for the Goldilocks plan.
    to_host: yield NumPy (int32 words as uint32; tuples for Goldilocks)
    or the device tensors.
    device: None is the card (RuntimeError without one), "cpu" runs fn on
    each batch in order. The device is resolved at the call, before the
    first batch is drawn."""
    if prefetch < 1:
        raise ValueError("prefetch must be >= 1")
    device = resolve_device(device)
    if device.type == "cuda":
        return _stream_cuda(fn, inputs, prefetch, to_host, device)
    return _stream_cpu(fn, inputs, to_host)


def _stream_cpu(fn, inputs, to_host) -> Iterator:
    for x in inputs:
        out = fn(_unplanes(tuple(_as_words(v) for v in _planes(x)), x))
        yield (_unplanes(tuple(_host_array(t) for t in _planes(out)), out)
               if to_host else out)


def _stream_cuda(fn, inputs, prefetch, to_host, device) -> Iterator:
    compute = torch.cuda.current_stream(device)
    up = torch.cuda.Stream(device)
    down = torch.cuda.Stream(device)

    def launch(x):
        staged = tuple(_as_words(v).pin_memory() for v in _planes(x))
        with torch.cuda.stream(up):
            dev_in = tuple(h.to(device, non_blocking=True) for h in staged)
            uploaded = torch.cuda.Event()
            uploaded.record(up)
        compute.wait_event(uploaded)
        for t in dev_in:
            t.record_stream(compute)
        out = fn(_unplanes(dev_in, x))
        if not to_host:  # later work on the current stream is ordered
            return out, None
        computed = torch.cuda.Event()
        computed.record(compute)
        down.wait_event(computed)
        with torch.cuda.stream(down):
            host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         .copy_(t, non_blocking=True) for t in _planes(out))
            done = torch.cuda.Event()
            done.record(down)
        for t in _planes(out):
            t.record_stream(down)
        return _unplanes(host, out), done

    def drain(entry):
        out, done = entry
        if done is None:
            return out
        done.synchronize()
        return _unplanes(tuple(_host_array(t) for t in _planes(out)), out)

    q: collections.deque = collections.deque()
    for x in inputs:
        q.append(launch(x))
        if len(q) < prefetch:  # strictly <: at most `prefetch` in flight
            continue
        yield drain(q.popleft())
    while q:
        yield drain(q.popleft())
