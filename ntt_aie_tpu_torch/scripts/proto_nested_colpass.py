"""The nested R x S column pass: its check and its A/B bench on the card.

Port of ``scripts/proto_nested_colpass.py`` (the round-4 prototype's
``check`` and ``bench`` modes) onto ``ops.nested_colpass``:

    python -m ntt_aie_tpu_torch.scripts.proto_nested_colpass check [--device cpu]
    python -m ntt_aie_tpu_torch.scripts.proto_nested_colpass bench [B] [chain]

``check`` runs the nested pass at (n1, n2) = (1024, 256) on random values
and holds four random columns, canonicalized, against the NumPy DIF
oracle ``reference.ntt_dif(...)[brev]`` placed at
``spectral_positions(R, S)``; it runs on the card, or with ``--device
cpu`` through the plain version.

``bench`` (card only) times, at (B, 1024, 1024) int32 (B = 64: 256 MiB)
and a dependent chain of `chain` calls per timed run:
- the probe line, the card's ideal butterfly rate
  (``profiling.roofline.measure_vpu_peak``) in Gbf/s and its per-call
  cost;
- one line per variant, us per call, Gbf/s and percent of the ideal rate:
  the column pass's kernel ``make_colpass(field, 1024, direction="dif")``
  ("plain colpass (current)") and ``nested_colpass`` at fuse = 1 to 5 (1
  is the one-stage-per-barrier baseline, 2 and 3 the prototype's levels,
  5 a whole 32-row phase in registers).
Each line is one JSON object on standard output.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.fields import P_469762049 as FIELD
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops.nested_colpass import make_nested_colpass
from ntt_aie_tpu_torch.utils.device import resolve_device

BENCH_N1 = BENCH_N2 = 1024
BENCH_FUSE = (1, 2, 3, 4, 5)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(device=None) -> dict:
    """The nested pass at (1024, 256) against the NumPy DIF oracle on four
    random columns; raises AssertionError on a mismatch."""
    device = resolve_device(device)
    n1, n2 = 1024, 256
    p = FIELD.p
    rng = np.random.default_rng(0)
    x = rng.integers(0, p, (n1, n2)).astype(np.uint32)
    fn, meta = make_nested_colpass(n1, n2, device=device)
    got = fn(torch.from_numpy(x.view(np.int32)).to(device))
    got = got.cpu().numpy().view(np.uint32).astype(np.int64)
    got = np.where(got >= 2 * p, got - 2 * p, got)
    got = np.where(got >= p, got - p, got)
    R, S = meta["R"], meta["S"]
    pos = tw.spectral_positions(R, S)  # natural[k] = flat[pos[k]]
    brev = tw.bit_reverse_indices(n1)
    cols = rng.choice(n2, 4, replace=False)
    for j in cols:
        X_nat = ref.ntt_dif(x[:, j].astype(np.int64), FIELD)[brev]
        want_flat = np.empty(n1, dtype=np.int64)
        want_flat[pos] = X_nat
        if not np.array_equal(got[:, j], want_flat):
            raise AssertionError(f"col {j} mismatch")
    out = {"check": "ok", "R": R, "S": S, "shape": [n1, n2],
           "columns": [int(j) for j in cols], "device": str(device),
           "order": f"spectral_positions({R},{S})"}
    _emit(out)
    return out


def bench(B: int = 64, chain: int = 8, device=None) -> list:
    """The probe line, then one line per variant (module docstring)."""
    from ntt_aie_tpu_torch.profiling import roofline
    from ntt_aie_tpu_torch.utils.timing import time_device

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench times the card; pass no --device")
    n1, n2 = BENCH_N1, BENCH_N2
    gen = torch.Generator(device=device).manual_seed(0)
    shape = (n1, n2) if B == 1 else (B, n1, n2)  # the prototype's shapes
    x = torch.randint(0, FIELD.p, shape, dtype=torch.int32, device=device,
                      generator=gen)

    ideal = roofline.measure_vpu_peak(iters=6, repeats=4, device=device)
    peak = ideal["butterflies_per_sec"]
    lines = [{"probe": "ideal", "gbf": peak / 1e9,
              "dispatch_us": ideal["dispatch_us_per_op"]}]
    _emit(lines[0])

    plain = C.make_colpass(FIELD, n1, direction="dif", device=device)
    variants = [("plain colpass (current)", plain, None)]
    for fz in BENCH_FUSE:
        nested, meta = make_nested_colpass(n1, n2, batch=B, fuse=fz,
                                           device=device)
        variants.append((f"nested {meta['R']}x{meta['S']} fuse={fz}",
                         nested, fz))

    def compose(f):
        def run(v):
            for _ in range(chain):
                v = f(v)
            return v
        return run

    bf = B * n2 * (n1 // 2) * (n1.bit_length() - 1)
    for name, f, fz in variants:
        res = time_device(compose(f), x, iters=3, repeats=4)
        us = res["us_per_iter"] / chain
        gbf = bf / (us * 1e-6) / 1e9
        line = {"pass": name, "fuse": fz, "us_per_call": us, "gbf": gbf,
                "pct_ideal": 100 * gbf * 1e9 / peak, "batch": B,
                "chain": chain}
        _emit(line)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("check", "bench"), nargs="?",
                    default="check")
    ap.add_argument("B", type=int, nargs="?", default=64)
    ap.add_argument("chain", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs check through the plain version "
                         "(bench times the card only)")
    args = ap.parse_args(argv)
    if args.mode == "check":
        check(args.device)
    else:
        if args.device is not None:
            ap.error("bench runs on the card; --device is for check only")
        bench(args.B, args.chain)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
