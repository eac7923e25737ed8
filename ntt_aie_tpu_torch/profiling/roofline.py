"""Cost models, the card's measured peaks, and the butterfly probe.

Port of ``ntt_aie_tpu/profiling/roofline.py`` (``:37-122``, ``:128-290``,
``:399-436``). The cost models (``butterflies``, ``model_ops``,
``bytes_per_transform``, ``efficiency_report``) are the reference's, so
efficiency numbers stay comparable with its plots. The peaks are the
card's:

- ``device_peaks``: the spec-sheet row of the card by
  ``torch.cuda.get_device_name()`` (H100 SXM: 3.35 TB/s HBM, 989 TFLOP/s
  dense bf16); unknown cards report None;
- ``measure_peak``: the measured HBM rate, the x -> x + 1 int32 stream over
  a 256 MB buffer (well beyond the 50 MB L2), K passes per timed call;
- ``measure_vpu_peak``: the measured ideal butterfly rate, the reference's
  probe chain ``u, w <- add(u, w), mul_const(sub_for_mul(u, w), tw)`` r
  deep per element with no network around it, on the kernel
  ``csrc/bfly_probe.cu`` (``probe_chain``; its plain version
  ``probe_chain_plain``), for the arithmetic of each 32-bit reduction or
  Goldilocks, net of the same launches at half the depth.

The probe's field per reduction (``PROBE_FIELDS``): harvey4 on
p = 469762049; harvey and montgomery on p = 998244353, as the reference's
probe runs them (its roofline.py:237); barrett on Kyber's p = 3329, where
the reference's probe has no barrett: p < 2^14 is the only field where
Barrett "2k" is defined, so its rate is Kyber's, the field the barrett
column and fused kernels run.

Neither subtracts the reference's tiny-buffer call: on the card its time
is the host's enqueue, which a device-bound call hides. measure_vpu_peak
still times it once, as the script bench's ``dispatch_us``.

``roofline_bound`` turns bytes and butterflies into the least time the card
could take. The measurements are card-only: they raise for the CPU. No TPU
calibration is carried over: ``CAL_H100`` holds the card's denominators
(its spec-sheet HBM rate and the probe's measured butterfly rates), and
``derive_trace_counters`` (reference ``roofline.py:314-396``) reads a
trace's column passes against them.
"""

from __future__ import annotations

import ctypes
import functools
import math
import re
from typing import Optional

import numpy as np
import torch

from ntt_aie_tpu_torch.fields import (GOLDILOCKS, KYBER, P_469762049,
                                     P_998244353)
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops.reductions import make_reduction
from ntt_aie_tpu_torch.utils.device import resolve_device
from ntt_aie_tpu_torch.utils.timing import time_device

# Spec-sheet numbers (HBM GB/s, dense bf16 TFLOP/s): NVIDIA's H100 SXM data
# sheet. The integer butterfly rate has no published peak; measure_vpu_peak
# measures it.
_DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (3350.0, 989.0),
}

# Probe launches per timed call: the reference's K barrier-separated passes
# per dispatch.
PROBE_K = 4
# The probe's field per 32-bit reduction, and its planes per arithmetic.
PROBE_FIELDS = {"harvey4": P_469762049, "harvey": P_998244353,
                "montgomery": P_998244353, "barrett": KYBER}
_PROBE_PLANES = dict.fromkeys(PROBE_FIELDS, 2) | {"goldilocks": 4}
# csrc/bfly_probe.cu's kind codes
_PROBE_CODES = {"harvey4": 0, "goldilocks": 1, "harvey": 2, "montgomery": 3,
                "barrett": 4}


def butterflies(n: int) -> int:
    """Total radix-2 butterflies in one size-n transform: n/2 * log2(n)."""
    return (n // 2) * int(math.log2(n))


def model_ops(n: int) -> float:
    """The reference's FLOP model (profile/plot_efficiency.py:25): 5.5 ops
    per element-stage — 5.5 * n * log2(n)."""
    return 5.5 * n * math.log2(n)


def bytes_per_transform(n: int, *, passes: int = 2, itemsize: int = 4) -> int:
    """HBM traffic model for a four-step transform: each pass reads and
    writes the full array once (twiddle tables are ignored)."""
    return passes * 2 * n * itemsize


def device_peaks(device_kind: Optional[str] = None) -> dict:
    """(hbm_gbps, bf16_tflops) for the current or named card."""
    if device_kind is None:
        device_kind = torch.cuda.get_device_name()
    hbm, tflops = _DEVICE_PEAKS.get(device_kind, (None, None))
    return {"device_kind": device_kind, "hbm_gbps": hbm, "bf16_tflops": tflops}


def roofline_bound(nbytes: float, nbfly: float, *, hbm_gbps: float,
                   bfly_per_sec: Optional[float]) -> dict:
    """The least time for work that moves `nbytes` and runs `nbfly`
    butterflies: the larger of bytes over hbm_gbps and butterflies over
    bfly_per_sec (omitted when None). Returns {"bound_ms", "bound_by",
    "bytes_ms", "operations_ms"}."""
    bytes_ms = nbytes / (hbm_gbps * 1e9) * 1e3
    ops_ms = nbfly / bfly_per_sec * 1e3 if bfly_per_sec else None
    by_ops = ops_ms is not None and ops_ms > bytes_ms
    return {"bound_ms": ops_ms if by_ops else bytes_ms,
            "bound_by": "operations" if by_ops else "bytes",
            "bytes_ms": bytes_ms, "operations_ms": ops_ms}


def _card(device) -> torch.device:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the roofline probes measure a CUDA device, "
                           f"got {device}")
    return device


def measure_peak(*, mb: int = 256, iters: int = 10, repeats: int = 5,
                 device=None) -> dict:
    """Measured HBM rate of the card: x -> x + 1 on an (mb MB) int32
    buffer, one read and one write per pass and no reuse (a column pass's
    traffic pattern), K = 8 passes per timed call.

    measured_hbm_gbps is the rate of that device-bound chain as it is. The
    reference nets out the same call on a tiny buffer; on the card that
    call's time is the host's enqueue, which the device-bound chain hides,
    so subtracting it would overstate the rate. Returns
    {"measured_hbm_gbps", "buffer_mb", "us_per_pass"}."""
    device = _card(device)
    K = 8

    def step(v):
        for _ in range(K):
            v = v + 1
        return v

    n = mb * 1024 * 1024 // 4
    x = torch.zeros(n, dtype=torch.int32, device=device)
    res = time_device(step, x, iters=iters, repeats=repeats)
    del x
    return {
        "measured_hbm_gbps": K * 2 * n * 4 / (res["us_per_iter"] * 1e-6)
        / 1e9,
        "buffer_mb": mb,
        "us_per_pass": res["us_per_iter"] / K,
    }


# ---- the butterfly probe ---------------------------------------------------

def _probe_kind(reduction: str) -> int:
    """The probe's plane count for `reduction`; raises for the others."""
    if reduction not in _PROBE_PLANES:
        raise ValueError(f"the probe runs {sorted(_PROBE_PLANES)}, got "
                         f"{reduction!r}")
    return _PROBE_PLANES[reduction]


def _probe_reduction(reduction: str):
    """The Reduction of a 32-bit probe, on its PROBE_FIELDS field."""
    return make_reduction(reduction, PROBE_FIELDS[reduction])


def probe_inputs(reduction: str, words: int, *, device=None, seed: int = 0):
    """The probe's operands from a seed: x, (planes, 8, m) int32 holding
    the (8, m) planes u, w (a 32-bit reduction: values in [0, p) of its
    PROBE_FIELDS field) or uh, ul, wh, wl (Goldilocks limbs, canonical),
    `words` uint32 in all; and tw, (2, 8) int32, one twiddle per row (a
    32-bit reduction: its (w, w2) pair, ``Reduction.pair``; Goldilocks: hi
    and lo limbs), never 0."""
    planes = _probe_kind(reduction)
    device = resolve_device(device)
    m = words // (8 * planes)
    if m < 1:
        raise ValueError(f"the probe needs at least {8 * planes} words")
    rng = np.random.default_rng(seed)
    if reduction in PROBE_FIELDS:
        p = PROBE_FIELDS[reduction].p
        vals = rng.integers(0, p, (planes, 8, m), dtype=np.int64)
        x = torch.from_numpy(vals.astype(np.uint32).view(np.int32))
        red = _probe_reduction(reduction)
        tw = C._pair(*red.pair(rng.integers(1, p, 8, dtype=np.int64)),
                     device)
        return x.to(device), tw
    p = np.uint64(GOLDILOCKS.p)
    vals = rng.integers(0, 1 << 63, (2, 8, m), dtype=np.uint64) % p
    (uh, ul), (wh, wl) = (M.gl_from_u64(v, device) for v in vals)
    tw = torch.stack(M.gl_from_u64(
        rng.integers(1, 1 << 63, 8, dtype=np.uint64) % p, device))
    return torch.stack([uh, ul, wh, wl]), tw


def probe_chain_plain(x: torch.Tensor, tw: torch.Tensor, *, r: int,
                      reduction: str = "harvey4") -> torch.Tensor:
    """r chained butterflies u, w <- add(u, w), mul_const(sub_for_mul(u,
    w), tw[row]) on the planes of x (probe_inputs' layout), in plain
    PyTorch ops on int64 carriers: the oracle the probe kernel is held
    against. A 32-bit reduction runs on its PROBE_FIELDS field (sub where
    it has no sub_for_mul); Goldilocks runs gl_add, gl_sub and gl_mul on
    limb pairs."""
    _check_probe(x, tw, reduction)
    planes = [M.to_carrier(v) for v in x]
    t0, t1 = (M.to_carrier(t).view(8, 1) for t in tw)
    if reduction in PROBE_FIELDS:
        red = _probe_reduction(reduction)
        subm = red.sub_for_mul or red.sub
        u, w = planes
        for _ in range(r):
            u, w = red.add(u, w), red.mulc_mat(subm(u, w), t0, t1)
        out = (u, w)
    else:
        uh, ul, wh, wl = planes
        for _ in range(r):
            sh, sl = M.gl_add(uh, ul, wh, wl)
            wh, wl = M.gl_mul(*M.gl_sub(uh, ul, wh, wl), t0, t1)
            uh, ul = sh, sl
        out = (uh, ul, wh, wl)
    return torch.stack([M.from_carrier(v) for v in out])


def _check_probe(x: torch.Tensor, tw: torch.Tensor, reduction: str) -> None:
    planes = _probe_kind(reduction)
    if x.dtype != torch.int32 or tw.dtype != torch.int32:
        raise TypeError("the probe takes int32 tensors")
    if x.dim() != 3 or tuple(x.shape[:2]) != (planes, 8) or \
            tuple(tw.shape) != (2, 8):
        raise ValueError(f"the {reduction} probe takes x ({planes}, 8, m) "
                         f"and tw (2, 8), got {tuple(x.shape)} and "
                         f"{tuple(tw.shape)}")
    if tw.device != x.device:
        raise ValueError(f"probe tw is on {tw.device}, x on {x.device}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(C.build_library("bfly_probe")))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ntt_bfly_probe.restype = ci
    lib.ntt_bfly_probe.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ci, ci,
                                   ctypes.c_uint, ctypes.c_uint,
                                   ctypes.c_uint, vp]
    lib.ntt_probe_error_string.restype = ctypes.c_char_p
    lib.ntt_probe_error_string.argtypes = [ci]
    return lib


def probe_chain(x: torch.Tensor, tw: torch.Tensor, *, r: int,
                reduction: str = "harvey4") -> torch.Tensor:
    """probe_chain_plain's function: the kernel in csrc/bfly_probe.cu on a
    CUDA tensor, the plain version on a CPU tensor. ``probe_chain.launches``
    counts kernel launches."""
    if x.device.type == "cpu":
        return probe_chain_plain(x, tw, r=r, reduction=reduction)
    if x.device.type != "cuda":
        raise ValueError(f"no butterfly probe for device {x.device}")
    _check_probe(x, tw, reduction)
    if not (x.is_contiguous() and tw.is_contiguous()):
        raise ValueError("the probe kernel takes contiguous tensors")
    if r < 0:
        raise ValueError(f"r must be >= 0, got {r}")
    out = torch.empty_like(x)
    consts = ((0, 0, 0) if reduction == "goldilocks" else
              (_probe_reduction(reduction).p,
               *_probe_reduction(reduction).consts))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ntt_bfly_probe(x.data_ptr(), out.data_ptr(),
                                 tw[0].data_ptr(), tw[1].data_ptr(),
                                 x.shape[2], r, _PROBE_CODES[reduction],
                                 *consts, stream)
    if err != 0:
        raise RuntimeError("CUDA butterfly probe launch failed: "
                           + lib.ntt_probe_error_string(err).decode())
    probe_chain.launches += 1
    return out


probe_chain.launches = 0


def measure_vpu_peak(*, reduction: str = "harvey4", mb: int = 32,
                     r: int = 64, iters: int = 10, repeats: int = 5,
                     device=None) -> dict:
    """Measured ideal butterfly rate of the card: the probe chain, r
    butterflies deep per element pair of an (mb MB) buffer, PROBE_K
    launches per timed call. This is the compute denominator the HBM rate
    cannot give: a kernel at this rate runs its butterflies at issue rate,
    and a gap localizes its overhead to the network (shared memory,
    barriers, tables, transpose). reduction: a 32-bit reduction (on its
    PROBE_FIELDS field) or 'goldilocks'.

    The rate is net of the same call at depth r // 2 on the same buffer:
    the difference of the two removes every fixed cost of a call (the
    buffer's load and store, which the kernel does not overlap with its
    chains, and the launches) and leaves r - r // 2 butterflies a pair.
    Both calls keep the card busy; a call at depth 0 would not (its time is
    the host's enqueue). The reference subtracts a tiny-buffer call
    instead; on the card that call's time is also the host's enqueue, which
    a device-bound call hides, so it is only reported, as
    dispatch_us_per_op (the script bench's per-call cost line). r must be
    at least 2. Returns
    {"butterflies_per_sec", "raw_butterflies_per_sec" (depth r, no
    subtraction), "half_depth_us_per_call", "dispatch_us_per_op",
    "us_per_pass", "reduction", "r", "buffer_mb"}."""
    planes = _probe_kind(reduction)
    if r < 2:
        raise ValueError(f"the probe needs r >= 2, got {r}")
    device = _card(device)
    x, tw = probe_inputs(reduction, mb * 1024 * 1024 // 4, device=device)

    def chain(depth):
        def step(v):
            for _ in range(PROBE_K):
                v = probe_chain(v, tw, r=depth, reduction=reduction)
            return v
        return step

    res = time_device(chain(r), x, iters=iters, repeats=repeats)
    half = time_device(chain(r // 2), x, iters=iters, repeats=repeats)
    tiny, _ = probe_inputs(reduction, 1024 * planes, device=device)
    base = time_device(chain(r), tiny, iters=iters, repeats=repeats)
    net_us = max(res["us_per_iter"] - half["us_per_iter"],
                 res["us_per_iter"] * 0.2)
    pairs = PROBE_K * x[0].numel()
    return {
        "butterflies_per_sec": pairs * (r - r // 2) / (net_us * 1e-6),
        "raw_butterflies_per_sec": pairs * r / (res["us_per_iter"] * 1e-6),
        "half_depth_us_per_call": half["us_per_iter"],
        "dispatch_us_per_op": base["us_per_iter"],
        "us_per_pass": res["us_per_iter"] / PROBE_K,
        "reduction": reduction,
        "r": r,
        "buffer_mb": mb,
    }


# The card's denominators, beside the card they were taken on: the HBM rate
# of NVIDIA's H100 SXM data sheet, and the ideal butterfly rate of each
# arithmetic that measure_vpu_peak measured there (chip_smoke.py phase 15,
# PERF.md section 6).
CAL_H100 = {
    "card": "NVIDIA H100 80GB HBM3, 700.00 W",
    "hbm_gbps": 3350.0,
    "bfly_per_sec": {"harvey4": 2.122e12, "harvey": 2.614e12,
                     "montgomery": 1.643e12, "barrett": 2.078e12,
                     "goldilocks": 0.517e12},
}

# The column-pass kernels' symbols (csrc/colpass.cu colpass_kernel<...>,
# csrc/gl_colpass.cu gl_colpass_kernel<...>), as the trace names them;
# nested_colpass_kernel, the fused kernel and torch's own kernels are not
# passes of a plan.
_PASS_KERNEL = re.compile(r"(?<!\w)(?:gl_)?colpass_kernel\b")


def derive_trace_counters(rows: list[dict], *, n: int, batch: int = 1,
                          itemsize: int = 4,
                          stages_per_pass=None,
                          pass_table_bytes: tuple = (0, 0),
                          hbm_gbps: Optional[float] = None,
                          vpu_bfly: Optional[float] = None) -> list[dict]:
    """Derived utilization planes per column pass of a fwd/inv trace
    summary (reference roofline.py:314-396): the achieved butterfly rate
    against the measured ideal rate (compute utilization) and the achieved
    HBM bandwidth against the card's rate.

    rows: summarize_trace output. The two passes are the two largest
    single-count rows whose op is a column-pass kernel (_PASS_KERNEL:
    the trace's demangled colpass_kernel<...> and gl_colpass_kernel<...>
    symbols), in program order by their first timestamp (summarize_trace's
    first_ts). Returns [] when no two such rows exist (e.g. the
    marker-pair rows of a CPU run).

    pass_table_bytes: extra HBM bytes per pass beyond the 2 * n * itemsize
    read and write (twiddle-matrix operands), in time order (pass 1, pass
    2). stages_per_pass: butterfly stages per pass in time order, an
    (s1, s2) tuple or an int for both; None is the even forward split
    (log2(n) // 2, log2(n) - log2(n) // 2). The denominators default to
    the card's (CAL_H100: 3.35 TB/s and harvey4's measured rate); pass
    the rate of the plan's arithmetic (CAL_H100["bfly_per_sec"]), or
    vpu_bfly=0 to omit the compute plane."""
    cand = [r for r in rows
            if r.get("count") == 1 and _PASS_KERNEL.search(r["op"])]
    cand = sorted(cand, key=lambda r: -r["total_us"])[:2]
    if len(cand) < 2:
        return []
    cand.sort(key=lambda r: r["first_ts"])
    hbm = hbm_gbps or CAL_H100["hbm_gbps"]
    vpu = (vpu_bfly if vpu_bfly is not None
           else CAL_H100["bfly_per_sec"]["harvey4"])
    logn = int(math.log2(n))
    if stages_per_pass is None:
        stages = (logn // 2, logn - logn // 2)
    elif isinstance(stages_per_pass, int):
        stages = (stages_per_pass, stages_per_pass)
    else:
        stages = tuple(stages_per_pass)
    out = []
    for i, r in enumerate(cand):
        t = r["total_us"] * 1e-6
        bfly_pass = batch * (n // 2) * stages[i]
        data_bytes = batch * 2 * n * itemsize + pass_table_bytes[i]
        gbf = bfly_pass / t / 1e9
        gbps = data_bytes / t / 1e9
        d = {
            "op": r["op"],
            "us": r["total_us"],
            "butterflies": bfly_pass,
            "gbf_per_sec": round(gbf, 2),
            "hbm_bytes": data_bytes,
            "achieved_gbps": round(gbps, 2),
            "hbm_utilization": round(gbps / hbm, 4),
        }
        if vpu:
            d["vpu_utilization"] = round(gbf * 1e9 / vpu, 4)
            d["bound"] = ("vpu" if gbf * 1e9 / vpu >= gbps / hbm
                          else "hbm")
        out.append(d)
    return out


def efficiency_report(seconds_per_transform: float, n: int, *,
                      device_kind: Optional[str] = None,
                      passes: int = 2, itemsize: int = 4,
                      measured_peak_gbps: Optional[float] = None,
                      measured_vpu_bfly: Optional[float] = None) -> dict:
    """Everything the reference's three plots derive, as one dict:
    throughput, butterfly rate, model GOPS (the 5.5 model), achieved HBM
    bandwidth, and efficiency vs the HBM roofline when the peak is known.

    Three efficiency denominators are reported when available:
    ``hbm_efficiency`` vs the spec-sheet peak (comparable across
    machines), ``hbm_efficiency_measured`` vs a measure_peak() number, and
    ``vpu_efficiency_measured`` vs a measure_vpu_peak() ideal butterfly
    rate."""
    t = seconds_per_transform
    rep = {
        "n": n,
        "us_per_transform": t * 1e6,
        "transforms_per_sec": 1.0 / t,
        "butterflies_per_sec": butterflies(n) / t,
        "model_gops": model_ops(n) / t / 1e9,
        "hbm_bytes": bytes_per_transform(n, passes=passes, itemsize=itemsize),
        "achieved_gbps": bytes_per_transform(n, passes=passes, itemsize=itemsize) / t / 1e9,
    }
    peaks = device_peaks(device_kind)
    rep.update(peaks)
    if peaks["hbm_gbps"]:
        rep["hbm_efficiency"] = rep["achieved_gbps"] / peaks["hbm_gbps"]
    if measured_peak_gbps:
        rep["measured_hbm_gbps"] = measured_peak_gbps
        rep["hbm_efficiency_measured"] = rep["achieved_gbps"] / measured_peak_gbps
    if measured_vpu_bfly:
        rep["measured_vpu_bfly_per_sec"] = measured_vpu_bfly
        rep["vpu_efficiency_measured"] = (rep["butterflies_per_sec"]
                                          / measured_vpu_bfly)
    return rep
