"""The port's command line (port of ``ntt_aie_tpu/cli.py``): one
program that runs the transforms, times them and verifies them against
the CPU oracles with a PASS/FAIL exit code.

    python -m ntt_aie_tpu_torch info
    python -m ntt_aie_tpu_torch verify --field P_2013265921 --log-n 12
    python -m ntt_aie_tpu_torch verify --parity          # reference parity
    python -m ntt_aie_tpu_torch bench  --field P_469762049 --log-n 20 --batch 32
    python -m ntt_aie_tpu_torch sweep  --field P_469762049 --log-ns 12-20 \\
        --batches 1,8,64 --out profile/exectime
    python -m ntt_aie_tpu_torch trace  --field P_469762049 --log-n 20
    python -m ntt_aie_tpu_torch scaling --devices 1,2 --backend gloo
    python -m ntt_aie_tpu_torch plot --summary DIR/summary_p469762049.csv

Every command but info and plot runs on the card; ``--device cpu`` runs
the plain PyTorch route on the CPU, whose times are the host's. The JSON's
``engine`` names the route: ``"cuda"`` on the card, ``"plain"`` on the
CPU. ``plot`` needs matplotlib.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from ntt_aie_tpu_torch import fields as F
from ntt_aie_tpu_torch.config import NTTConfig


def _field(name: str):
    """Accept registry names ('p2013265921') and module attribute names
    ('P_2013265921', 'GOLDILOCKS'), case-insensitively."""
    key = name.lower().replace("_", "")
    for reg_name, f in F.FIELDS.items():
        if reg_name.lower().replace("_", "") == key:
            return f
    attr = getattr(F, name.upper(), None)
    if attr is not None:
        return attr
    sys.exit(f"unknown field {name!r}; choices: {', '.join(F.FIELDS)}")


def _rand_input(rng, field, n):
    if field.p >= (1 << 32):
        v = rng.integers(0, 1 << 32, n, dtype=np.uint64) << np.uint64(32)
        v |= rng.integers(0, 1 << 32, n, dtype=np.uint64)
        return (v % np.uint64(field.p)).astype(np.uint64)
    return rng.integers(0, field.p, n)


def _host(v) -> np.ndarray:
    """A result as a host array: a tensor's int32 words as uint32, NumPy
    (the Goldilocks uint64 interface) as it is."""
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
        return v.view(np.uint32) if v.dtype == np.int32 else v
    return np.asarray(v)


def _words(a, device) -> torch.Tensor:
    """Field values below 2^31 as an int32 tensor on `device`."""
    return torch.from_numpy(np.asarray(a).astype(np.int32)).to(device)


def cmd_info(args) -> int:
    import ntt_aie_tpu_torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"ntt_aie_tpu_torch {ntt_aie_tpu_torch.__version__}")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"devices: {count}")
    for i in range(min(count, 4)):
        print(f"  {i}: {torch.cuda.get_device_name(i)} (cuda)")
    print("fields:")
    for name, f in F.FIELDS.items():
        print(
            f"  {name:<14} p={f.p:<22} g={f.g:<3} max_n=2^{f.max_n.bit_length() - 1}"
            f"  reduction={f.default_reduction()}"
        )
    return 0


def _check(label: str, ok: bool, failures: list) -> None:
    print(f"  [{'PASS' if ok else 'FAIL'}] {label}")
    if not ok:
        failures.append(label)


def _native_gate(label, failures, kind, p, n, root, a, claimed, b=None):
    from ntt_aie_tpu_torch import native_oracle as native

    with tempfile.NamedTemporaryFile(suffix=".nttv") as tf:
        native.write_vectors(tf.name, kind, p, n, root, a, claimed, b=b)
        _check(label, native.run_verify_gate(tf.name), failures)


def cmd_verify(args) -> int:
    """Device-vs-oracle verification (the reference's PASS/FAIL gate,
    src/test.cpp:221-247). Exit 0 on PASS, 1 on FAIL."""
    from ntt_aie_tpu_torch import reference as ref
    from ntt_aie_tpu_torch.api import NTTContext

    dev = args.device
    failures: list = []
    rng = np.random.default_rng(args.seed)

    if args.parity:
        # the reference's bit-exact mode: p=3329, logN=11, a[i]=i, the
        # natural-order table through the butterfly network, ANS_ORDER_16
        cfg = NTTConfig(field=F.KYBER, log_n=11, table_convention="reference",
                        ordering="reference")
        ctx = NTTContext(cfg, device=dev)
        a = np.arange(1 << 11)
        got = _host(ctx.forward(a))
        want = ref.reference_device_output(a, F.KYBER, 1 << 11)
        _check("reference device parity (logN=11, p=3329)",
               np.array_equal(got.astype(np.int64), want), failures)
    else:
        field = _field(args.field)
        cfg = NTTConfig(field=field, log_n=args.log_n, ordering="natural")
        ctx = NTTContext(cfg, device=dev)
        a = _rand_input(rng, field, cfg.n)
        big = field.p >= (1 << 32)

        def dev_in(v):
            return v if big else _words(v, dev)

        fwd = _host(ctx.forward(dev_in(a)))
        want = ref.ntt_forward(a.astype(object) if big else a, field)
        _check(f"forward vs oracle (n=2^{args.log_n})",
               np.array_equal(fwd.astype(object), want.astype(object)),
               failures)

        back = _host(ctx.inverse(fwd if big else dev_in(fwd)))
        _check("inverse roundtrip", np.array_equal(back, a), failures)

        if args.log_n <= 12:
            b = _rand_input(rng, field, cfg.n)
            got = _host(ctx.polymul(dev_in(a), dev_in(b)))
            wantp = ref.cyclic_polymul(
                a.astype(object) if big else a,
                b.astype(object) if big else b, field)
            _check("cyclic polymul vs oracle",
                   np.array_equal(got.astype(object), wantp.astype(object)),
                   failures)
            if 2 * cfg.n <= field.max_n and not big:
                # the negacyclic (X^n + 1) gate, the RLWE product path
                nctx = NTTContext(NTTConfig(field=field, log_n=args.log_n,
                                            negacyclic=True), device=dev)
                ngot = _host(nctx.negacyclic_polymul(dev_in(a), dev_in(b)))
                nwant = ref.schoolbook_negacyclic(a, b, field.p)
                _check("negacyclic polymul vs schoolbook",
                       np.array_equal(ngot.astype(np.int64), nwant), failures)

        if field.p == 3329:
            # the ML-KEM (FIPS 203) pipeline, gated by the NumPy schoolbook
            # and (with --native) the C++ schoolbook
            from ntt_aie_tpu_torch import kyber as KY

            ka = rng.integers(0, 3329, 256)
            kb = rng.integers(0, 3329, 256)
            kgot = _host(KY.kyber_polymul(_words(ka, dev), _words(kb, dev)))
            kwant = ref.schoolbook_negacyclic(ka, kb, 3329)
            _check("ML-KEM ring product vs schoolbook",
                   np.array_equal(kgot.astype(np.int64), kwant), failures)
            if args.native:
                _native_gate("native C++ gate (nttverify, ML-KEM ring)",
                             failures, "negacyclic_schoolbook", 3329, 256, 0,
                             ka.astype(np.uint64), kgot.astype(np.uint64),
                             b=kb.astype(np.uint64))

        if field.p == 8380417:
            # the ML-DSA (FIPS 204) pipeline: the complete 8-layer NTT,
            # the pointwise product, the inverse
            from ntt_aie_tpu_torch import dilithium as DL

            da = rng.integers(0, DL.Q, 256)
            db = rng.integers(0, DL.Q, 256)
            dgot = _host(DL.dilithium_polymul(_words(da, dev),
                                              _words(db, dev)))
            dwant = ref.schoolbook_negacyclic(da, db, DL.Q)
            _check("ML-DSA ring product vs schoolbook",
                   np.array_equal(dgot.astype(np.int64), dwant), failures)
            if args.native:
                _native_gate("native C++ gate (nttverify, ML-DSA ring)",
                             failures, "negacyclic_schoolbook", DL.Q, 256, 0,
                             da.astype(np.uint64), dgot.astype(np.uint64),
                             b=db.astype(np.uint64))

        if args.native:
            # the independent gate: the separately compiled C++ oracle
            # (native/verify_main.cc) re-derives the forward and compares
            from ntt_aie_tpu_torch import twiddles as tw_mod

            claimed_bitrev = fwd[tw_mod.bit_reverse_indices(cfg.n)]
            _native_gate("native C++ gate (nttverify, forward)", failures,
                         "forward", field.p, cfg.n,
                         field.root_of_unity(cfg.n), a.astype(np.uint64),
                         claimed_bitrev.astype(np.uint64))

    if failures:
        print("FAIL.")
        return 1
    print("PASS!")
    return 0


def cmd_bench(args) -> int:
    from ntt_aie_tpu_torch.plan import build_plan
    from ntt_aie_tpu_torch.profiling import roofline
    from ntt_aie_tpu_torch.profiling.sweep import (device_kind, host_input,
                                                   route)
    from ntt_aie_tpu_torch.utils.timing import time_device

    dev = args.device
    field = _field(args.field)
    cfg = NTTConfig(field=field, log_n=args.log_n)
    plan = build_plan(cfg, device=dev,
                      wmat_factored=True if args.wmat_factored else None,
                      wmat_fold=False if args.no_wmat_fold else None)
    if args.wmat_factored and not plan.wmat_factored:
        print("warning: --wmat-factored ignored (needs a four-step split); "
              "timing the full-matrix path", file=sys.stderr)
    rng = np.random.default_rng(0)
    batched = plan.make_batched(args.batch)
    big = field.p >= (1 << 32)
    vals = rng.integers(0, min(field.p, 1 << 32), (args.batch, cfg.n))
    a = host_input(vals, field, dev)

    if args.op == "polymul":
        pm = batched["polymul"]
        fn = lambda x: pm(x, x)  # noqa: E731  out shape == in shape
        transforms_per_call = 3 * args.batch  # 2 fwd + 1 inv per polymul
    else:
        fn = batched[args.op]
        transforms_per_call = args.batch
    res = time_device(fn, a, iters=args.iters, repeats=args.repeats)

    # the correctness gate, after timing (the reference program's
    # benchmark-then-verify structure, src/test.cpp:157-247): the timed
    # callable's output against the golden oracle on sampled rows
    gate_ok = _gate_bench_output(plan, cfg, args.op, fn, a, vals, rng)

    measured = vpu_bfly = None
    if args.calibrate:
        measured = roofline.measure_peak(device=dev)["measured_hbm_gbps"]
        vpu_bfly = roofline.measure_vpu_peak(
            reduction=plan.reduction, device=dev)["butterflies_per_sec"]
    rep = roofline.efficiency_report(
        res["us_per_iter"] / transforms_per_call * 1e-6, cfg.n,
        device_kind=device_kind(dev), itemsize=8 if big else 4,
        measured_peak_gbps=measured, measured_vpu_bfly=vpu_bfly)
    rep.update(engine=route(dev), reduction=plan.reduction,
               batch=args.batch, op=args.op,
               wmat_factored=plan.wmat_factored,
               wmat_fold=plan.wmat_fold,
               clock=res["clock"],
               verified=gate_ok)
    del rep["hbm_bytes"]
    print(json.dumps(rep))
    if not gate_ok:
        print("FAIL: benchmarked output does not match the oracle",
              file=sys.stderr)
        return 1
    return 0


def _gate_bench_output(plan, cfg, op: str, fn, a, vals, rng) -> bool:
    """Oracle gate for cmd_bench's timed callable: run it once more and
    compare sampled rows with the native C++ oracle (the NumPy oracle when
    the native library is unavailable, and only then). All three ops and
    both value widths:

      fwd     — spectral output mapped to natural vs a forward NTT
      inv     — the random input rows are read as spectral data; the
                expected coefficients come from the oracle's inverse
      polymul — fn squares its input; vs the cyclic-convolution oracle
    """
    from ntt_aie_tpu_torch import native_oracle as native
    from ntt_aie_tpu_torch import twiddles as tw_mod
    from ntt_aie_tpu_torch.ops import modops as M

    field = cfg.field
    n, p = cfg.n, field.p
    big = p >= (1 << 32)
    B = vals.shape[0]
    nrows = min(3, B)
    rows = np.concatenate([[0], rng.choice(np.arange(1, B),
                                           size=nrows - 1, replace=False)]) \
        if B > 1 else np.array([0])

    out = fn(a)
    sel = tuple(t.reshape(B, n)[torch.from_numpy(rows).to(t.device)]
                for t in (out if big else (out,)))
    got = (M.gl_to_u64(*sel) if big else _host(sel[0])).astype(np.uint64)

    pos = plan.spectral_to_natural
    brev = tw_mod.bit_reverse_indices(n)
    omega = field.root_of_unity(n)
    rv = vals[rows].astype(np.uint64)
    try:
        if op == "fwd":
            want = native.ntt_dif_batch(rv, omega, p)[:, brev]
            got = got[:, pos]
        elif op == "inv":
            # a row read as plan-spectral s: natural spectral S = s[pos];
            # DIT consumes DIF (bit-reversed) order, so feed S[brev]
            oinv = field.inv(omega)
            want = np.stack([native.ntt_dit(r[pos][brev], oinv, p, scale=True)
                             for r in rv])
        else:  # polymul (fn squares)
            want = np.stack([native.cyclic_polymul(r, r, omega, p)
                             for r in rv])
    except native.NativeOracleUnavailable:  # the NumPy oracle instead
        from ntt_aie_tpu_torch import reference as ref

        dt = object if big else np.int64
        if op == "fwd":
            want = np.stack([ref.ntt_forward(r.astype(dt), field)
                             for r in rv]).astype(object)
            got = got[:, pos]
        elif op == "inv":
            want = np.stack([ref.ntt_inverse(r[pos].astype(dt), field)
                             for r in rv]).astype(object)
        else:
            want = np.stack([ref.cyclic_polymul(r.astype(dt), r.astype(dt),
                                                field)
                             for r in rv]).astype(object)
        return bool(np.array_equal(got.astype(object), want))
    return bool(np.array_equal(got, want.astype(np.uint64)))


def cmd_sweep(args) -> int:
    from ntt_aie_tpu_torch.profiling.sweep import run_sweep

    lo, hi = (int(x) for x in args.log_ns.split("-"))
    batches = [int(x) for x in args.batches.split(",")]
    run_sweep(_field(args.field), range(lo, hi + 1), batches,
              iters=args.iters, out_dir=args.out, device=args.device)
    return 0


def cmd_trace(args) -> int:
    from ntt_aie_tpu_torch.plan import build_plan, flat_inner_split
    from ntt_aie_tpu_torch.profiling.roofline import (CAL_H100,
                                                      derive_trace_counters)
    from ntt_aie_tpu_torch.profiling.sweep import (device_kind, host_input,
                                                   route)
    from ntt_aie_tpu_torch.profiling.trace import (
        capture_trace, marker_pair_times, summarize_trace,
    )

    dev = args.device
    field = _field(args.field)
    cfg = NTTConfig(field=field, log_n=args.log_n)
    plan = build_plan(cfg, device=dev,
                      wmat_factored=True if args.wmat_factored else None,
                      wmat_fold=False if args.no_wmat_fold else None)
    rng = np.random.default_rng(0)
    big = field.p >= (1 << 32)
    a = host_input(rng.integers(0, min(field.p, 1 << 32), cfg.n), field, dev)
    op = args.op
    if op == "inv":
        traced, x0 = plan.inv, plan.fwd(a)
    elif op == "polymul":
        traced, x0 = (lambda v: plan.polymul(v, v)), a
    else:
        traced, x0 = plan.fwd, a
    d = capture_trace(traced, x0, trace_dir=args.out)
    print(f"trace written to {d}")
    rows = summarize_trace(d)
    method = "profiler"
    if not rows:
        if dev.type == "cuda":
            print("error: the profiler recorded no device event on the "
                  "card; no trace summary", file=sys.stderr)
            return 1
        # the plain route on the CPU has no device events: time the
        # transforms as dependent chains instead (host clock)
        print("no device events in profiler trace (CPU); falling back to "
              "marker-pair dispatch chains")
        rows = marker_pair_times({
            "forward_ntt": (plan.fwd, a),
            "inverse_ntt": (plan.inv, plan.fwd(a)),
        }, iters=args.iters)
        method = "marker_pairs"
    for row in rows:
        print(f"  {row['total_us']:10.2f} us  {row['op']}")
    derived = []
    if method == "profiler" and op in ("fwd", "inv"):
        # The full-matrix four-step multiply streams two n-sized tables
        # (the (w, w') pairs, or Goldilocks limb planes) with one pass: the
        # first executed (the transposing one, cp1 / icp2) on the fold
        # plan, the second on the wmat_fold=False plan. The factored
        # tables are about sqrt(n) (counted as 0).
        wmat_bytes = 0 if plan.wmat_factored else 2 * cfg.n * 4
        wmat_pass = 0 if plan.wmat_fold else 1
        # per-pass stages in time order: the forward runs n1-point
        # columns first, the inverse n2 first; a flat plan runs its
        # internal split
        n1_, n2_ = (cfg.split if cfg.split[1] > 1 else
                    flat_inner_split(cfg.log_n, goldilocks=big))
        s1, s2 = n1_.bit_length() - 1, n2_.bit_length() - 1
        stages = (s1, s2) if op == "fwd" else (s2, s1)
        derived = derive_trace_counters(
            rows, n=cfg.n, itemsize=8 if big else 4,
            stages_per_pass=stages,
            pass_table_bytes=((wmat_bytes, 0) if wmat_pass == 0
                              else (0, wmat_bytes)),
            vpu_bfly=CAL_H100["bfly_per_sec"][plan.reduction])
        for r in derived:
            print(f"  derived {r['op']}: {r['gbf_per_sec']} Gbf/s "
                  f"({r['vpu_utilization']:.0%} of the measured ideal), "
                  f"{r['achieved_gbps']} GB/s "
                  f"({r['hbm_utilization']:.0%} of HBM) -> "
                  f"{r['bound']}-bound")
    if args.summary_out:
        payload = {
            "method": method,
            "op": op,
            "field": field.name,
            "log_n": args.log_n,
            "engine": route(dev),
            "device_kind": device_kind(dev),
            "backend": dev.type,
            "wmat_factored": bool(plan.wmat_factored),
            "wmat_fold": bool(plan.wmat_fold),
            "ops": rows,
            "denominators": CAL_H100,
        }
        if derived:
            payload["derived"] = derived
        os.makedirs(os.path.dirname(args.summary_out) or ".", exist_ok=True)
        with open(args.summary_out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"summary written to {args.summary_out}")
    return 0


def cmd_scaling(args) -> int:
    from ntt_aie_tpu_torch.profiling.scaling import run_scaling

    counts = [int(x) for x in args.devices.split(",")]
    if args.full_wmat:
        wfac = False
    elif args.wmat_factored:
        wfac = True
    else:
        wfac = None  # the distributed builder's default (factored)
    rows = run_scaling(_field(args.field), args.log_n, counts,
                       mode=args.mode, batch=args.batch, iters=args.iters,
                       overlap_chunks=args.overlap_chunks,
                       topology=args.topology, wmat_factored=wfac,
                       hier_groups=args.hier_groups, device=args.device,
                       backend=args.backend)
    print(json.dumps(rows))
    return 0


def cmd_plot(args) -> int:
    from ntt_aie_tpu_torch.profiling import plots

    written = plots.render_all(args.summary, args.out)
    for p in written:
        print(p)
    return 0


def _device_arg(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="'cpu' runs the plain PyTorch route on the CPU "
                             "(default: the card)")


def main(argv=None) -> int:
    from ntt_aie_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="ntt_aie_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("info").set_defaults(fn=cmd_info)

    pv = sub.add_parser("verify")
    pv.add_argument("--field", default="P_2013265921")
    pv.add_argument("--log-n", type=int, default=12)
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--parity", action="store_true",
                    help="reference bit-exact parity mode")
    pv.add_argument("--native", action="store_true",
                    help="also run the standalone C++ nttverify gate")
    _device_arg(pv)
    pv.set_defaults(fn=cmd_verify)

    pb = sub.add_parser("bench")
    pb.add_argument("--field", default="P_469762049")
    pb.add_argument("--log-n", type=int, default=20)
    pb.add_argument("--batch", type=int, default=32)
    pb.add_argument("--iters", type=int, default=20)
    pb.add_argument("--repeats", type=int, default=5)
    pb.add_argument("--op", default="fwd", choices=["fwd", "inv", "polymul"])
    pb.add_argument("--wmat-factored", action="store_true",
                    help="the four-step multiply from the factored "
                         "sqrt-size tables (the A/B arm of the full matrix)")
    pb.add_argument("--no-wmat-fold", action="store_true",
                    help="the four-step multiply at the second pass's entry "
                         "instead of the default fold into the transposing "
                         "pass's exit ('post_t')")
    pb.add_argument("--calibrate", action="store_true",
                    help="measure the card's streaming HBM rate and the "
                         "ideal butterfly rate of the plan's arithmetic, "
                         "and report efficiency against both")
    _device_arg(pb)
    pb.set_defaults(fn=cmd_bench)

    ps = sub.add_parser("sweep")
    ps.add_argument("--field", default="P_469762049")
    ps.add_argument("--log-ns", default="12-20")
    ps.add_argument("--batches", default="1,8,64")
    ps.add_argument("--iters", type=int, default=20)
    ps.add_argument("--out", default=None)
    _device_arg(ps)
    ps.set_defaults(fn=cmd_sweep)

    pt = sub.add_parser("trace")
    pt.add_argument("--field", default="P_469762049")
    pt.add_argument("--log-n", type=int, default=18)
    pt.add_argument("--iters", type=int, default=20)
    pt.add_argument("--op", default="fwd", choices=["fwd", "inv", "polymul"],
                    help="which pipeline to trace (inv/polymul localize "
                         "the DIT-pass cost)")
    pt.add_argument("--out", default=None)
    pt.add_argument("--summary-out", default=None,
                    help="write the per-op summary JSON here")
    pt.add_argument("--wmat-factored", action="store_true",
                    help="trace the factored-twiddle plan")
    pt.add_argument("--no-wmat-fold", action="store_true",
                    help="trace the plan with the four-step multiply at the "
                         "second pass's entry (bench's flag)")
    _device_arg(pt)
    pt.set_defaults(fn=cmd_trace)

    pc = sub.add_parser("scaling")
    pc.add_argument("--field", default="P_469762049")
    pc.add_argument("--log-n", type=int, default=18)
    pc.add_argument("--devices", default="1,2,4,8")
    pc.add_argument("--mode", default="strong", choices=["strong", "weak"])
    pc.add_argument("--batch", type=int, default=4)
    pc.add_argument("--iters", type=int, default=5)
    pc.add_argument("--overlap-chunks", type=int, default=1,
                    help="chunk the four-step transpose collective")
    pc.add_argument("--wmat-factored", action="store_true",
                    help="factored sqrt-size four-step twiddle tables "
                         "(the distributed default; kept for explicitness)")
    pc.add_argument("--full-wmat", action="store_true",
                    help="force the full n1 x n2 twiddle matrices")
    pc.add_argument("--topology", default="fourstep",
                    choices=["fourstep", "pairwise"],
                    help="'pairwise' times the reference's per-stage "
                         "exchange topology for comparison")
    pc.add_argument("--hier-groups", type=int, default=1,
                    help="G > 1 runs fourstep cells on a (G, D/G) "
                         "two-level mesh")
    pc.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="nccl: one card a rank (the default on the card); "
                         "gloo: CPU ranks, or ranks that share one card "
                         "(never a multi-chip figure)")
    _device_arg(pc)
    pc.set_defaults(fn=cmd_scaling)

    pp = sub.add_parser("plot")
    pp.add_argument("--summary",
                    default="profile/exectime/summary_p469762049.csv")
    pp.add_argument("--out", default="profile/plots")
    pp.set_defaults(fn=cmd_plot)

    args = ap.parse_args(argv)
    if hasattr(args, "device"):
        try:
            args.device = resolve_device(args.device)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
