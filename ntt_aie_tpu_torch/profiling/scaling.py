"""Scaling harness: NTT/s of the distributed plan at 1 -> D ranks.

Port of ``ntt_aie_tpu/profiling/scaling.py``. The reference times one
controller's mesh of 1..D devices; here each device count is one spawn of
D ranks (``parallel.launch.run_spmd``), each rank building
``parallel.fourstep``'s plan on ``parallel.mesh``'s mesh and timing a
dependent chain between barriers, and the row reports the slowest rank.

Strong scaling: fixed total n = 2^log_n over D ranks; efficiency =
rate(D) / (rate(first D) * D / first D). Weak scaling: n = 2^log_n * D;
efficiency = rate(D) / rate(first D).

The backend is explicit (``parallel.mesh``): ``nccl`` takes one card a
rank, ``gloo`` runs on the CPU or with ranks that share a card. Every row
records the backend, the cards its ranks ran on and their placement
(``"cpu"``, ``"a card a rank"`` or ``"ranks share one card"``), and the
column kernels' launches summed over the ranks. A row of
ranks that share a card is never a multi-chip figure: the ranks take
turns on one card and gloo stages the collective through the host. A
device count the backend cannot place (NCCL with more ranks than cards)
is skipped with a printed line, as the reference skips a mesh larger than
its devices.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ntt_aie_tpu_torch.config import NTTConfig
from ntt_aie_tpu_torch.parallel.mesh import BACKENDS
from ntt_aie_tpu_torch.utils.device import resolve_device


def _placement(device_type: str, D: int, cards: int) -> str:
    if device_type == "cpu":
        return "cpu"
    return "a card a rank" if D <= cards else "ranks share one card"


def run_scaling(field, log_n: int, device_counts: Iterable[int] = (1, 2, 4, 8),
                *, mode: str = "strong", batch: int = 4, iters: int = 5,
                repeats: int = 3, verbose: bool = True,
                overlap_chunks: int = 1, topology: str = "fourstep",
                wmat_factored: bool | None = None, hier_groups: int = 1,
                device=None, backend: Optional[str] = None) -> list[dict]:
    """Time the distributed forward NTT over meshes of increasing size.

    mode='strong': fixed total n = 2^log_n over D ranks; 'weak': n =
    2^log_n * D. Each fourstep iteration is fwd then inv on `batch` inputs
    (2 * batch transforms); topology='pairwise' times the reference's
    pairwise exchange forward instead (batch transforms an iteration).
    overlap_chunks > 1 chunks the transpose (falls back to 1 where n1 does
    not divide by D * chunks); hier_groups = G > 1 runs a fourstep cell on
    a (G, D/G) two-level mesh for D divisible by G and above it.
    wmat_factored: None is the distributed default (factored).

    device: None is the card (RuntimeError without one), "cpu" the plain
    route on CPU ranks. backend: None is nccl on the card and gloo on the
    CPU; 'gloo' with the card runs ranks that share it. Returns one row
    per placed mesh size with ntts_per_sec and efficiency."""
    from ntt_aie_tpu_torch.parallel.launch import run_spmd

    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL runs on the card: pass backend='gloo' for "
                         "CPU ranks")
    if mode not in ("strong", "weak"):
        raise ValueError(f"mode must be 'strong' or 'weak', got {mode!r}")
    if topology not in ("fourstep", "pairwise"):
        raise ValueError(f"topology must be 'fourstep' or 'pairwise', got "
                         f"{topology!r}")
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    rows = []
    base_rate: Optional[float] = None
    base_d = 1
    rng = np.random.default_rng(0)
    for D in device_counts:
        if backend == "nccl" and D > cards:
            if verbose:
                print(f"D={D}: skipped (nccl takes one card a rank; "
                      f"{cards} card(s))")
            continue
        ln = log_n if mode == "strong" else log_n + (D.bit_length() - 1)
        # a square-ish split: n1 (the transpose) and n2 (the columns) both
        # divide by D
        cfg = NTTConfig(field=field, log_n=ln, num_shards=D,
                        rows_log2=ln // 2)
        n1, n2 = cfg.split
        hier = (hier_groups > 1 and topology == "fourstep"
                and D % hier_groups == 0 and D > hier_groups)
        chunks = (overlap_chunks if n1 % (D * overlap_chunks) == 0 else 1)
        spec = {"field": field.name, "log_n": ln, "rows_log2": ln // 2,
                "D": D, "hier": (hier_groups, D // hier_groups) if hier
                else None, "topology": topology, "chunks": chunks,
                "wmat_factored": wmat_factored, "iters": iters,
                "repeats": repeats, "device_type": device.type,
                "a": rng.integers(0, min(field.p, 1 << 32),
                                  (batch, n1 * n2))}
        res = run_spmd(_scaling_rank, D, backend=backend,
                       device_type=device.type, args=(spec,))
        per_iter = batch if topology == "pairwise" else 2 * batch
        us_per_ntt = max(r["us_per_iter"] for r in res) / per_iter
        rate = 1e6 / us_per_ntt
        if base_rate is None:
            base_rate, base_d, eff = rate, D, 1.0
        elif mode == "strong":
            eff = rate / (base_rate * (D / base_d))
        else:
            eff = rate / base_rate
        used = min(D, cards) if device.type == "cuda" else 0
        row = {
            "devices": D,
            "log_n": ln,
            "split": cfg.split,
            "us_per_ntt": round(us_per_ntt, 2),
            "ntts_per_sec": round(rate, 2),
            "efficiency": round(eff, 4),
            "mode": mode,
            "topology": topology,
            "overlap_chunks": (overlap_chunks if topology == "fourstep"
                               else None),
            "wmat_factored": ((True if wmat_factored is None
                               else bool(wmat_factored))
                              if topology == "fourstep" else None),
            "hier": list(spec["hier"]) if hier else None,
            "backend": backend,
            "cards": used,
            "placement": _placement(device.type, D, cards),
            "clock": "host",
            "launches": sum(r["launches"] for r in res),
        }
        rows.append(row)
        if verbose:
            print(f"D={D}  n=2^{ln}  {us_per_ntt:10.1f} us/NTT  "
                  f"{rate:10.1f} NTT/s  eff={eff:6.1%}  {backend}, "
                  f"{row['placement']}"
                  + (" (not a multi-chip figure)"
                     if row["placement"] == "ranks share one card" else ""))
    return rows


def _scaling_rank(rank: int, world: int, spec: dict) -> dict:
    """One rank of a scaling cell (run_spmd): build the mesh and the plan,
    place this rank's blocks of spec['a'], and time spec['iters'] chained
    iterations spec['repeats'] times, each between a device synchronize
    and a barrier, on the host clock. Returns {"us_per_iter" (trimmed
    mean), "runs_us", "launches" (the column kernels' launches of this
    rank's calls, warm-up included)}."""
    from ntt_aie_tpu_torch import fields as F
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.parallel import fourstep as FS
    from ntt_aie_tpu_torch.parallel import mesh as MS
    from ntt_aie_tpu_torch.utils.timing import synchronize, trimmed_mean

    device = (torch.device("cuda", torch.cuda.current_device())
              if spec["device_type"] == "cuda" else torch.device("cpu"))
    field = F.FIELDS[spec["field"]]
    cfg = NTTConfig(field=field, log_n=spec["log_n"], num_shards=spec["D"],
                    rows_log2=spec["rows_log2"])
    backend = dist.get_backend()
    hier_axes = None
    if spec["hier"]:
        hier_axes = ("dcn", "ici")
        mesh = MS.make_mesh_hier(*spec["hier"], axes=hier_axes,
                                 device=device, backend=backend)
    else:
        mesh = MS.make_mesh(spec["D"], cfg.mesh_axis, device=device,
                            backend=backend)
    a = spec["a"]
    if spec["topology"] == "pairwise":
        fwd, shard = FS.build_pairwise_plan(cfg, mesh, device=device)
        xs = [shard(v) for v in a]

        def step(ys):
            return [fwd(y) for y in ys]
    else:
        build = (FS.build_gl_distributed_plan if field.is_goldilocks
                 else FS.build_distributed_plan)
        plan = build(cfg, mesh, device=device,
                     overlap_chunks=spec["chunks"],
                     wmat_factored=spec["wmat_factored"],
                     hier_axes=hier_axes)
        if field.is_goldilocks:
            a = a.astype(np.uint64)
        xs = [plan.shard_input(v) for v in a]

        def step(ys):
            return [plan.inv(plan.fwd(y)) for y in ys]

    def chain():
        ys = xs
        for _ in range(spec["iters"]):
            ys = step(ys)
        return ys

    C.colpass.launches = G.gl_colpass.launches = 0
    chain()  # warm-up: builds the kernels on first use
    runs = []
    for _ in range(spec["repeats"]):
        synchronize(device)
        dist.barrier()
        t0 = time.perf_counter()
        chain()
        synchronize(device)
        runs.append((time.perf_counter() - t0) * 1e6 / spec["iters"])
    return {"us_per_iter": trimmed_mean(runs), "runs_us": runs,
            "launches": C.colpass.launches + G.gl_colpass.launches}
