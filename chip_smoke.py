#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--seed N]

It drives the port's main path — the n = 2^20 forward NTT over
p = 469762049 as ``build_plan(...).make_batched(256)["fwd_mat"]``, its
inverse and the cyclic product — through the CUDA column-pass kernel, and
exits non-zero at the first failure. Phases, one JSON object per line:

  1. env     — the card (nvidia-smi's name and power limit, also printed
               as its own line), torch and CUDA versions;
  2. build   — compiles csrc/colpass.cu with nvcc into build/ and times it;
  3. kernel  — the kernel against its plain PyTorch version on the card,
               for cp1/cp2/icp2/icp1 at the 1024x1024 split and at 128x512
               (plain and nested column networks), B = 4, bit-exact;
  4. slice   — fwd_mat on a 1 GiB int32 batch (B = 256) gated against the
               native C++ oracle on row 0 plus 8 random rows (the NumPy
               oracle if the library cannot build); inv_mat(fwd_mat(x)) == x
               on the whole batch; polymul_mat against the NumPy cyclic
               product; kernel launch counts 2 / 2 / 6;
  5. time    — us/NTT of fwd_mat through the kernel and through the plain
               version, and us/pass of cp1 and cp2, on CUDA events.

Then one line {"kernels": [...]} and, last, the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it prints no result and exits 2.
"""

import argparse
import json
import subprocess
import sys
import time


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> int:
    emit({"phase": phase, "ok": False, "error": msg})
    return 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2

    import numpy as np

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch import native_oracle, reference
    from ntt_aie_tpu_torch import twiddles as tw
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.plan import fold_passes
    from ntt_aie_tpu_torch.utils.timing import time_device

    field = T.P_469762049
    p = field.p
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)

    # 1. env
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    print(card or "nvidia-smi: not available", flush=True)
    emit({"phase": "env", "ok": True, "card": card,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    # 2. build
    t0 = time.perf_counter()
    lib_path = C.build_library()
    C._library()
    emit({"phase": "build", "ok": True,
          "seconds": time.perf_counter() - t0, "library": lib_path.name})

    # 3. kernel against plain, on the card
    max_err = 0
    for n1, n2 in ((1024, 1024), (128, 512)):
        for name, cp in fold_passes(field, n1, n2, device=dev).items():
            rows, cols = (n1, n2) if name in ("cp1", "icp1") else (n2, n1)
            x = torch.randint(0, 4 * p, (4, rows, cols), dtype=torch.int64,
                              device=dev, generator=gen).to(torch.int32)
            got = C.colpass(x, cp)
            torch.cuda.synchronize()
            want = C.colpass_plain(x, cp)
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            emit({"phase": "kernel", "pass": name, "shape": [4, rows, cols],
                  "network": "nested" if cp.wmid is not None else "plain",
                  "equal": bool(torch.equal(got, want)), "max_abs_err": err})
            if err:
                return fail("kernel", f"{name} {rows}x{cols} differs from "
                            "its plain version")

    # 4. slice: the main path at n = 2^20, B = 256
    cfg = T.NTTConfig(field=field, log_n=20)
    n, (n1, n2) = cfg.n, cfg.split
    B = 256
    plan = T.build_plan(cfg, device=dev)
    bat = plan.make_batched(B)
    x = torch.randint(0, p, (B, n1, n2), dtype=torch.int32, device=dev,
                      generator=gen)
    launches = {}
    C.colpass.launches = 0
    y = bat["fwd_mat"](x)
    torch.cuda.synchronize()
    launches["fwd_mat"] = C.colpass.launches

    gate_rows = np.concatenate(
        [[0], rng.choice(np.arange(1, B), size=8, replace=False)])
    got = y.reshape(B, n)[torch.from_numpy(gate_rows).to(dev)].cpu().numpy()
    rows_in = x.reshape(B, n)[torch.from_numpy(gate_rows).to(dev)].cpu()
    rows_in = rows_in.numpy().astype(np.uint64)
    try:
        want = native_oracle.ntt_dif_batch(
            rows_in, field.root_of_unity(n), p)[:, tw.bit_reverse_indices(n)]
        oracle = "native"
    except (native_oracle.NativeOracleUnavailable, OSError):
        want = np.stack([reference.ntt_forward(r, field) for r in rows_in])
        oracle = "numpy"
    gate_ok = np.array_equal(
        got[:, plan.spectral_to_natural].astype(np.uint64),
        want.astype(np.uint64))

    C.colpass.launches = 0
    back = bat["inv_mat"](y)
    torch.cuda.synchronize()
    launches["inv_mat"] = C.colpass.launches
    roundtrip_ok = bool(torch.equal(back, x))
    del back, y

    bat2 = plan.make_batched(2)
    a, b = x[:2], x[2:4]
    C.colpass.launches = 0
    c = bat2["polymul_mat"](a, b)
    torch.cuda.synchronize()
    launches["polymul_mat"] = C.colpass.launches
    want_c = reference.cyclic_polymul(a[0].reshape(n).cpu().numpy(),
                                      b[0].reshape(n).cpu().numpy(), field)
    poly_ok = np.array_equal(c[0].reshape(n).cpu().numpy().astype(np.int64),
                             want_c)
    counts_ok = launches == {"fwd_mat": 2, "inv_mat": 2, "polymul_mat": 6}
    emit({"phase": "slice", "n": n, "split": [n1, n2], "batch": B,
          "reduction": plan.reduction, "oracle": oracle,
          "gate_rows": gate_rows.tolist(), "gate_ok": bool(gate_ok),
          "roundtrip_ok": roundtrip_ok, "polymul_ok": bool(poly_ok),
          "launches": launches, "launches_ok": counts_ok,
          "ok": gate_ok and roundtrip_ok and poly_ok and counts_ok})
    if not (gate_ok and roundtrip_ok and poly_ok and counts_ok):
        return fail("slice", "the main path disagrees with its oracles")

    # 5. time: kernel path at B = 256, plain path at B = 256 or less
    cp1, cp2 = plan.passes["cp1"], plan.passes["cp2"]
    k_fwd = time_device(bat["fwd_mat"], x)["us_per_iter"]
    k_cp1 = time_device(cp1, x)["us_per_iter"]
    k_cp2 = time_device(cp2, x)["us_per_iter"]

    def plain_fwd(v):
        return C.colpass_plain(C.colpass_plain(v, cp1), cp2)

    pb = B
    while True:
        try:
            xp = x[:pb]
            p_fwd = time_device(plain_fwd, xp)["us_per_iter"]
            p_cp1 = time_device(lambda v: C.colpass_plain(v, cp1),
                                xp)["us_per_iter"]
            p_cp2 = time_device(lambda v: C.colpass_plain(v, cp2),
                                xp)["us_per_iter"]
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            if pb == 1:
                raise
            pb //= 2
    timing = {
        "phase": "time", "card": card, "batch": B, "plain_batch": pb,
        "kernel_us_per_ntt": k_fwd / B,
        "plain_us_per_ntt": p_fwd / pb,
        "kernel_cp1_us_per_pass": k_cp1 / B,
        "kernel_cp2_us_per_pass": k_cp2 / B,
        "plain_cp1_us_per_pass": p_cp1 / pb,
        "plain_cp2_us_per_pass": p_cp2 / pb,
        "kernel_ntt_per_s": B / (k_fwd * 1e-6),
        "method": "CUDA events, 5 repeats of a dependent chain of 10, "
                  "trimmed mean; us per NTT = us per call / batch",
    }
    emit(timing)

    # ms per launch in the fwd_mat chain (one call is 2 launches), at the
    # batch each path was timed at
    emit({"kernels": [{
        "name": "colpass", "route": "cuda",
        "source": "ntt_aie_tpu_torch/csrc/colpass.cu",
        "replaces": "ntt_aie_tpu/ops/pallas_ntt.py:298",
        "launches": sum(launches.values()), "max_abs_err": max_err,
        "ms": k_fwd / 2 / 1e3, "plain_ms": p_fwd / 2 / 1e3,
        "batch": B, "plain_batch": pb,
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
