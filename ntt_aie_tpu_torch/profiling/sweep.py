"""Benchmark sweep harness -> the reference's CSVs.

Port of ``ntt_aie_tpu/profiling/sweep.py``. Each (log_n, batch) cell
builds a plan, times its batched forward transform (``utils.timing
.time_device``: CUDA events on the card, the host clock on the CPU) and
writes, as the reference does:

- one raw-runs CSV per cell, ``ntt_<field>_b<B>_logn<k>.csv`` (one µs per
  NTT a line, each repeat's reading);
- ``dummy_<field>.csv``, the dispatch baseline: an ``x + 1`` on a small
  int32 tensor, timed both ways (chained, and one call's synchronized
  wall clock), the latter's runs written;
- ``summary_<field>.csv``, one row a cell: the reference's columns, then
  ``clock`` (which clock timed the cell).

The columns keep the reference's names. ``engine`` names the route:
``"cuda"`` (the kernels, on the card) or ``"plain"`` (the plain PyTorch
version, on the CPU); a CPU sweep's times are the host's, not a device
metric.
"""

from __future__ import annotations

import csv
import os
from typing import Iterable, Optional

import numpy as np
import torch

from ntt_aie_tpu_torch.config import NTTConfig
from ntt_aie_tpu_torch.profiling import roofline
from ntt_aie_tpu_torch.utils.device import resolve_device


def route(device: torch.device) -> str:
    """The route a plan on `device` runs: "cuda" (the kernels) or
    "plain" (the plain PyTorch version on the CPU)."""
    return "cuda" if device.type == "cuda" else "plain"


def device_kind(device: torch.device) -> str:
    """The card's name, or "cpu"."""
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def host_input(vals: np.ndarray, field, device):
    """Random field values (int64, below min(p, 2^32)) as a plan's input
    on `device`: an int32 tensor, or Goldilocks (hi, lo) planes."""
    if field.p >= (1 << 32):
        from ntt_aie_tpu_torch.ops import modops as M

        return M.gl_from_u64(vals.astype(np.uint64), device)
    return torch.from_numpy(vals.astype(np.int32)).to(device)


def run_sweep(field, log_ns: Iterable[int], batches: Iterable[int] = (1,), *,
              reduction: str = "auto", iters: int = 20, repeats: int = 5,
              out_dir: Optional[str] = None, verbose: bool = True,
              device=None) -> list[dict]:
    """Time the batched forward NTT over a (log_n, batch) grid on `device`
    (None: the card, RuntimeError without one; "cpu": the plain route).

    Returns one row dict per cell; writes CSVs when out_dir is given.
    """
    from ntt_aie_tpu_torch.plan import build_plan
    from ntt_aie_tpu_torch.utils.timing import time_device, time_host_dispatch

    device = resolve_device(device)
    kind = device_kind(device)
    rows = []
    rng = np.random.default_rng(0)

    # the dispatch baseline (the reference's empty-kernel dummy.csv,
    # profile/plot_exectime.py:36-41), timed both ways
    def ident(v):
        return v + 1

    dummy_x = torch.zeros((8, 128), dtype=torch.int32, device=device)
    dres = time_device(ident, dummy_x, iters=iters, repeats=repeats)
    dhost = time_host_dispatch(ident, dummy_x)
    dispatch_chain_us = dres["us_per_iter"]
    dispatch_e2e_us = dhost["us_trimmed_mean"]
    if verbose:
        print(f"dispatch baseline: {dispatch_chain_us:.1f} us/op chained, "
              f"{dispatch_e2e_us:.1f} us host E2E ({dres['clock']})")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"dummy_{field.name}.csv"), "w") as f:
            for v in dhost["runs_us"]:
                f.write(f"{v}\n")

    # the measured HBM rate of the card, the calibrated denominator; the
    # CPU has none
    measured_gbps = None
    if device.type == "cuda":
        peak = roofline.measure_peak(iters=iters, repeats=repeats,
                                     device=device)
        measured_gbps = peak["measured_hbm_gbps"]
        if verbose:
            print(f"measured HBM peak: {measured_gbps:.0f} GB/s "
                  f"({peak['buffer_mb']} MB streaming read+write)")
    big = field.p >= (1 << 32)
    for log_n in log_ns:
        n = 1 << log_n
        cfg = NTTConfig(field=field, log_n=log_n, reduction=reduction)
        plan = build_plan(cfg, device=device)
        for batch in batches:
            bat = plan.make_batched(batch)
            vals = rng.integers(0, min(field.p, 1 << 32), (batch, n))
            a = host_input(vals, field, device)
            res = time_device(bat["fwd"], a, iters=iters, repeats=repeats)
            us_per_ntt = res["us_per_iter"] / batch
            # the matrix-form serving callable where the split is square
            n1_, n2_ = cfg.split
            mat_us_per_ntt = None
            fwd_mat = bat.get("fwd_mat") if n2_ > 1 else None
            if fwd_mat is not None and n1_ == n2_:
                am = (tuple(v.reshape(batch, n1_, n2_) for v in a) if big
                      else a.reshape(batch, n1_, n2_))
                mres = time_device(fwd_mat, am, iters=iters, repeats=repeats)
                mat_us_per_ntt = round(mres["us_per_iter"] / batch, 4)
            # net of the chained dispatch baseline (the reference's
            # E2E-minus-dummy subtraction)
            net_us_per_ntt = max(res["us_per_iter"] - dispatch_chain_us,
                                 1e-3) / batch
            rep = roofline.efficiency_report(us_per_ntt * 1e-6, n,
                                             device_kind=kind,
                                             itemsize=8 if big else 4,
                                             measured_peak_gbps=measured_gbps)
            row = {
                "field": field.name,
                "log_n": log_n,
                "batch": batch,
                "engine": route(device),
                "reduction": plan.reduction,
                "us_per_ntt": round(us_per_ntt, 4),
                "mat_us_per_ntt": mat_us_per_ntt,
                "net_us_per_ntt": round(net_us_per_ntt, 4),
                "dispatch_us": round(dispatch_chain_us, 4),
                "ntts_per_sec": round(rep["transforms_per_sec"], 1),
                "butterflies_per_sec": rep["butterflies_per_sec"],
                "model_gops": round(rep["model_gops"], 2),
                "achieved_gbps": round(rep["achieved_gbps"], 2),
                "hbm_efficiency": round(rep.get("hbm_efficiency") or 0.0, 4),
                "hbm_efficiency_measured": round(
                    rep.get("hbm_efficiency_measured") or 0.0, 4),
                "runs_us": res["runs_us"],
                "clock": res["clock"],
            }
            rows.append(row)
            if verbose:
                print(f"logn={log_n:2d} b={batch:<4d} {us_per_ntt:9.2f} "
                      f"us/NTT  {rep['transforms_per_sec']:10.0f} NTT/s  "
                      f"{rep['achieved_gbps']:7.1f} GB/s  ({res['clock']})")
            if out_dir:
                raw = os.path.join(
                    out_dir, f"ntt_{field.name}_b{batch}_logn{log_n}.csv")
                with open(raw, "w") as f:
                    for v in res["runs_us"]:
                        f.write(f"{v / batch}\n")
    if out_dir and rows:
        cols = [k for k in rows[0] if k != "runs_us"]
        with open(os.path.join(out_dir, f"summary_{field.name}.csv"), "w",
                  newline="") as f:
            w = csv.DictWriter(f, fieldnames=cols, extrasaction="ignore")
            w.writeheader()
            w.writerows(rows)
    return rows
