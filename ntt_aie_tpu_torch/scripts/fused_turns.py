"""The fused and the fold transform, and the fold plan's two column passes,
of several checkouts, timed in turns on one card.

    python -m ntt_aie_tpu_torch.scripts.fused_turns [--root NAME=DIR ...]
        [--nested] [--gl] [--crt] [--ring] [--tall] [--limit] [--steps]
        [--split] [--reduction KIND]
    python -m ntt_aie_tpu_torch.scripts.fused_turns --sync

Each root is a checkout: a directory that holds ``ntt_aie_tpu_torch/``,
such as an unpacked ``git archive`` of another commit, or of this one with
a constant changed (``kFuse`` in ``csrc/fused_fourstep.cu`` or
``csrc/colpass.cu``). This checkout
is the root "this". The roots' kernels are built first, all at once. Then
one child process per reading
imports one root's package (``PYTHONPATH``) and times, at n = 2^20 over
p = 469762049 and batch B = 256 (the main path's; with ``--reduction``
harvey or montgomery, over the prime where 'auto' picks it, p = 998244353
or 2013265921, with that reduction's libraries), ``make_batched(B)``'s
``fwd_mat`` and ``inv_mat`` of the fused plan and of the fold plan, and
the fold plan's column passes cp1 and cp2 alone (``fwd_mat`` is cp1 then
cp2; ``utils.timing.time_device``: CUDA events, 5 repeats of a dependent
chain of 10, trimmed mean), checks that the fused ``fwd_mat`` equals the
fold plan's bit for bit, and reads the column kernel's ``kernel_info``
for cp1 and cp2 where the root's package has it. With ``--nested`` each
reading also times, at the nested prototype's bench shape (B = 64,
1024 x 1024), the column pass ``make_colpass(field, 1024, "dif")`` and
the nested R x S pass ``make_nested_colpass`` at fuse 1 to 5 (us per
call, the same timing), checks that the nested pass at fuse 3 equals the
column pass bit for bit, and reads ``nested_colpass.kernel_info`` per
fuse where the root's package has it. With ``--gl`` each reading also
times the Goldilocks fold plan at n = 2^20 and B = 64 (the Goldilocks
path's): ``make_batched(64)``'s ``fwd_mat``, ``inv_mat`` and
``polymul_mat`` (of x with itself) and its column passes cp1 and cp2
alone, hashes the three outputs' bits (which must agree across every
reading of every root: the kernels are exact) and reads
``gl_colpass.kernel_info`` for cp1 and cp2 where the root's package has
it. With ``--crt`` each reading also times the CRT combine of the RNS
product (``ops.crt.make_crt_combine`` over the three default RNS primes,
on random canonical residues of B = 16 products of n = 2^20: the kernel
``csrc/crt.cu``; us per call) and hashes its limbs, which must agree
across every reading of every root. With ``--ring`` each reading also
times the FIPS 203/204 rings (``csrc/ring_layers.cu``) through the
pipelines (``kyber.make_pipeline``, ``dilithium.make_pipeline``):
``ntt``, ``intt`` and ``polymul`` at B = 8,192 and the ML-KEM-768 and
ML-DSA-65 serving steps ``make_serving_step(A_hat)(x)`` at B = 1,024,
each as a call (the wrapper's host work included) and on the card alone
(a CUDA graph of calls cycling over copies of the input, so that the
input comes cold from device memory, not from L2), and hashes the
outputs, which must
agree across every reading of every root. With ``--tall`` each reading
also times the tall route of the column passes (a column above 8,192
rows as two launches, ``colpass.tall_phases``) at the 8192 x 16384 split
of n = 2^27, B = 1: cp2 (DIF) and icp2 (DIT, transpose_out, a 'post_t'
operand of random canonical values in the plan's (n1, n2) shape) over
16,384 rows, under BabyBear's montgomery and over Goldilocks, each launch
alone (``colpass_phase``, ``gl_colpass_phase``) and the whole pass, us
per call, and hashes the passes' outputs, which must agree across every
reading of every root that has the route. With ``--limit`` each reading
also times BabyBear's cp1 (DIF, 'post_t', transpose_out) and icp1 (DIT,
canonicalize) under montgomery at 8192 x 16384 and 4096 x 32768, B = 1,
each as one whole-column launch and through its tall route's two
launches, the pass and each launch alone (us per call), compares the two
routes' outputs bit for bit and reads kernel_info of each; and times
Goldilocks's cp1 and icp1 at 8192 x 16384, 4096 x 32768, 2048 x 65536
and 4096 x 4096 as one whole-column launch at each tile width of 2 and 4
columns that fits (128 KB at most) and through the tall route, and its
factored arm's cp1 and icp1 on columns of 2, 4 and 8 rows at n = 2^28 on
the column tile and on the short kernel (where the root has it), the
routes' outputs compared bit for bit (``_measure_gl_limit``). With
``--steps`` each reading also times the fused plan against the fold plan
at BabyBear n = 2^27 (8192 x 16384, B = 1), p = 469762049 at (1, 2^20),
B = 1, and BabyBear n = 2^17 at 8 x 16384 and 16384 x 8, B = 2:
``fwd_mat`` and ``inv_mat`` a call (CUDA events, each call on the same
input), each fused transform's device time alone (a chain enqueued
behind a sleep kernel), its kernel_info, and the fused ``fwd_mat``
compared with the fold's bit for bit. With ``--split`` each reading also
times, at B = 1, each launch alone (us per call) of the passes whose tall
phases split by stage group: BabyBear (1, 2^27)'s cp2 and icp2 and
Goldilocks (2, 2^27)'s factored cp2 and icp2 (their plans' own passes),
and DIF passes (``SPLIT_PASSES``) over 32-bit (1, 2^26, 2) and (1, 2^26,
4) under montgomery and Goldilocks (1, 2^27, 1) and (1, 2^26, 4), whose
phase A 'lo' launch moves runs of 1, 2 and 4 words; each pass whole, its
kernel_info and its output's hash (which must agree across every reading
of every root); and the callables of those plans and of the fused (1,
2^27) plan (``SPLIT_PLANS``: its ff also on the device alone). The
readings go in turns: the
roots in order, then in reverse (a b c c b a).

``--sync`` times nothing else: it builds ``scripts/grid_sync.cu`` and
times cooperative launches of 1, 2 and 4 empty steps (a counter add a
block a step, a grid sync between steps) at 4 blocks of 256 threads an
SM, the step kernel's grid at BabyBear n = 2^27 (528 blocks on an H100),
each alone on the device (behind a sleep kernel); one sync's cost is the
slope, (t4 - t1) / 3. It prints one line.

Prints one JSON line per reading, then one summary line: per root, the
mean of its readings in us per NTT (us per pass per NTT for cp1 and cp2;
us per call for the nested bench shape), and the card's name and power
limit (nvidia-smi). Exits 1 if a reading failed, a fused output differed
from the fold plan's, a nested one from the column pass's, or two
readings' Goldilocks outputs, CRT limbs, ring outputs or split passes'
outputs from each other, or a tall route's output from the whole
column's. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import pathlib
import subprocess
import sys

THIS_ROOT = pathlib.Path(__file__).resolve().parents[2]
LOG_N = 20
BATCH = 256
NESTED_BATCH, NESTED_N = 64, 1024  # the nested prototype's bench shape
NESTED_FUSE = (1, 2, 3, 4, 5)
GL_BATCH = 64  # the Goldilocks path's batch
CRT_BATCH = 16  # the RNS products of chip_smoke.py's rns phase
# the rings' batches (chip_smoke.py's phase 29) and serving shapes
RING_BATCH, RING_SERVING_BATCH = 8192, 1024
RING_SERVING = {"kyber": (3, 3), "dilithium": (6, 5)}
# the alone readings cycle over input copies that move at least this many
# bytes between two uses of one copy (4x the H100's 50 MB L2)
RING_COLD_BYTES = 200_000_000
# the field each reduction's transforms run on
REDUCTION_FIELDS = {"harvey4": "p469762049", "harvey": "p998244353",
                    "montgomery": "p2013265921"}
# the tall route's split: n = 2^27 at 8192 x 16384, cp2 and icp2 tall
TALL_N1, TALL_N2 = 8192, 16384
# --limit: the 32-bit whole-column launch against the tall route at the
# two heights a launch limit could fall between, over BabyBear n = 2^27
LIMIT_SHAPES = ((8192, 16384), (4096, 32768))
# --limit, Goldilocks: its whole-column launch at each tile width against
# the tall route at n = 2^27 (8192 x 16384, 4096 x 32768, 2048 x 65536)
# and 2^24 (4096 x 4096); and its column tile against the short kernel on
# columns of 2, 4 and 8 rows at n = 2^28
GL_LIMIT_SHAPES = ((8192, 16384), (4096, 32768), (2048, 65536),
                   (4096, 4096))
GL_TILE_COLS = (2, 4)
GL_SHORT_SHAPES = ((2, 1 << 27), (4, 1 << 26), (8, 1 << 25))
# --steps: the fused plan's step lists against the fold plan's calls,
# (field, log_n, rows_log2 (None: the default split), batch)
STEP_CASES = (("p2013265921", 27, None, 1), ("p469762049", 20, 0, 1),
              ("p2013265921", 17, 3, 2), ("p2013265921", 17, 14, 2))
# --split: the plans whose passes split a tall phase by stage group, B = 1,
# (tag, field, log_n, rows_log2, build_plan keywords, passes, callables);
# and DIF passes over (1, nn, ncols) whose phase A's 'lo' launch moves runs
# of 1, 2 and 4 words, (tag, field, nn, ncols)
SPLIT_PLANS = (
    ("babybear_1x2^27", "p2013265921", 27, 0, {}, ("cp2", "icp2"),
     ("fwd_mat", "polymul_mat")),
    ("fused_babybear_1x2^27", "p2013265921", 27, 0, {"fused": True}, (),
     ("fwd_mat",)),
    ("gl_2x2^27_factored", "goldilocks", 28, 1, {"wmat_factored": True},
     ("cp2", "icp2"), ("fwd_mat",)))
SPLIT_PASSES = (("babybear_2x2^26", "p2013265921", 1 << 26, 2),
                ("babybear_4x2^26", "p2013265921", 1 << 26, 4),
                ("gl_1x2^27", "goldilocks", 1 << 27, 1),
                ("gl_4x2^26", "goldilocks", 1 << 26, 4))
# --pointwise: the 32-bit ring products, (reduction, field, log_n,
# rows_log2, batch): the main path's n = 2^20 at B = 256 under harvey4,
# harvey and montgomery, and barrett on Kyber's 16 x 16 split at B = 16,384
POINTWISE_CASES = (("harvey4", "p469762049", 20, 10, 256),
                   ("harvey", "p998244353", 20, 10, 256),
                   ("montgomery", "p2013265921", 20, 10, 256),
                   ("barrett", "kyber", 8, 4, 16384))
SYNC_STEPS = (1, 2, 4)  # --sync: the empty step lists' lengths
SYNC_BLOCKS_PER_SM = 4  # --sync: the step kernel's (kStepMinBlocks)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _run_child(root: pathlib.Path, flags: list
               ) -> subprocess.CompletedProcess:
    """One reading of root's package, in a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(root))
    return subprocess.run([sys.executable, __file__, "--child", *flags],
                          env=env, capture_output=True, text=True)


def _measure_gl() -> dict:
    """The Goldilocks fold plan's transforms and cp1, cp2 at n = 2^20,
    B = GL_BATCH: us per NTT, the outputs' bit hashes and kernel_info."""
    import hashlib

    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.ops import modops as M
    from ntt_aie_tpu_torch.utils.timing import time_device

    dev = torch.device("cuda", 0)
    field = T.GOLDILOCKS
    cfg = T.NTTConfig(field=field, log_n=LOG_N, rows_log2=LOG_N // 2)
    n1, n2 = cfg.split
    plan = T.build_plan(cfg, device=dev)
    bat = plan.make_batched(GL_BATCH)
    gen = torch.Generator(device=dev).manual_seed(2)
    hi, lo = (M.from_carrier(torch.randint(
        0, 1 << 32, (GL_BATCH, n1, n2), dtype=torch.int64, device=dev,
        generator=gen)) for _ in range(2))
    x = (hi, torch.where(hi == -1, torch.zeros_like(lo), lo))  # < p
    fns = {"fwd_mat": bat["fwd_mat"], "inv_mat": bat["inv_mat"],
           "polymul_mat": lambda v: bat["polymul_mat"](v, v)}
    out = {"gl_batch": GL_BATCH, "gl_hashes": {}}
    for key, fn in fns.items():
        h = hashlib.sha256()
        for v in fn(x):
            h.update(v.cpu().numpy())
        out["gl_hashes"][key] = h.hexdigest()
        us = time_device(fn, x)["us_per_iter"]
        out[f"gl_{key}_us_per_ntt"] = us / GL_BATCH
    for key in ("cp1", "cp2"):
        us = time_device(plan.passes[key], x)["us_per_iter"]
        out[f"gl_{key}_us_per_ntt"] = us / GL_BATCH
    if hasattr(G, "kernel_info"):
        out["gl_kernel_info"] = {key: G.kernel_info(plan.passes[key], n2)
                                 for key in ("cp1", "cp2")}
    return out


def _measure_crt() -> dict:
    """The CRT combine of CRT_BATCH products of n = 2^20 over the default
    RNS primes: us per call and a hash of the limbs."""
    import hashlib

    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import crt
    from ntt_aie_tpu_torch.utils.timing import time_device

    dev = torch.device("cuda", 0)
    fields = (T.P_2013265921, T.P_998244353, T.P_469762049)
    cc, _ = crt.make_crt_combine(fields, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    res = [torch.randint(0, f.p, (CRT_BATCH, 1 << LOG_N), dtype=torch.int32,
                         device=dev, generator=gen) for f in fields]
    limbs = cc(*res)
    us = time_device(lambda t: (cc(*res), t)[1], res[0])["us_per_iter"]
    return {"crt_batch": CRT_BATCH, "crt_us_per_call": us,
            "crt_hash": hashlib.sha256(limbs.cpu().numpy()).hexdigest()}


def _graph_us(fn, inputs, repeats=5) -> float:
    """us per call of fn(v) on the card alone with its inputs cold in L2:
    a CUDA graph of max(20, len(inputs)) calls cycling over `inputs`,
    replayed between CUDA events `repeats` times, trimmed mean. The
    script's own copy of utils.timing.time_graph: a reading imports
    another checkout's package, which may predate it."""
    import numpy as np
    import torch

    chain = max(20, len(inputs))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(inputs[0])  # warm-up outside the capture
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
    return float(np.mean(sorted(runs)[1:-1]))


def _measure_ring() -> dict:
    """The rings' ntt, intt, polymul (RING_BATCH) and serving steps
    (RING_SERVING_BATCH) through the pipelines: us per call, us on the
    card alone, and the outputs' hashes."""
    import hashlib

    import torch

    from ntt_aie_tpu_torch import dilithium, kyber
    from ntt_aie_tpu_torch.utils.timing import time_device

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    out = {"ring_hashes": {}}
    for name, mod in (("kyber", kyber), ("dilithium", dilithium)):
        k, l = RING_SERVING[name]
        pipe = mod.make_pipeline(device=dev)

        def draw(*shape):
            return torch.randint(0, mod.Q, shape, dtype=torch.int32,
                                 device=dev, generator=gen)

        x, b = draw(RING_BATCH, 256), draw(RING_BATCH, 256)
        xs, A = draw(RING_SERVING_BATCH, l, 256), draw(k, l, 256)
        step = pipe["make_serving_step"](pipe["ntt"](A))
        calls = {"ntt": (pipe["ntt"], x), "intt": (pipe["intt"], x),
                 "polymul": (lambda v: pipe["polymul"](v, b), x),
                 "serving_step": (lambda v: step(v)[:, :l], xs)}
        for call, (fn, arg) in calls.items():
            key = f"ring_{name}_{call}"
            out["ring_hashes"][key] = hashlib.sha256(
                fn(arg).cpu().numpy()).hexdigest()
            out[f"{key}_us_per_call"] = time_device(fn, arg)["us_per_iter"]
            copies = [arg] + [arg.clone() for _ in range(
                min(31, RING_COLD_BYTES // (8 * arg.numel())))]
            out[f"{key}_alone_us_per_call"] = _graph_us(fn, copies)
            del copies
    return out


def _measure_tall() -> dict:
    """The tall passes cp2 and icp2 at TALL_N1 x TALL_N2, B = 1, under
    BabyBear's montgomery and over Goldilocks: us per call of each launch
    and of the pass, and the passes' output hashes."""
    import hashlib

    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.ops import modops as M
    from ntt_aie_tpu_torch.utils.timing import time_device

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {"tall_hashes": {}}
    for name, field in (("babybear", T.P_2013265921),
                        ("goldilocks", T.GOLDILOCKS)):
        gl = field.is_goldilocks
        wmat = rng.integers(0, field.p if not gl else 1 << 63,
                            (TALL_N1, TALL_N2), dtype=np.uint64)
        if gl:
            make, phase, kw = G.make_gl_colpass, G.gl_colpass_phase, {}
        else:
            make, phase = C.make_colpass, C.colpass_phase
            kw = {"reduction": "montgomery"}
        passes = {"cp2": make(field, TALL_N2, direction="dif", device=dev,
                              **kw),
                  "icp2": make(field, TALL_N2, direction="dit",
                               inverse_tw=True, transpose_out=True,
                               wmat=wmat, device=dev, **kw)}
        del wmat
        hi = torch.randint(0, (1 << 32) - 1, (1, TALL_N2, TALL_N1),
                           dtype=torch.int64, device=dev, generator=gen)
        if gl:
            x = (M.from_carrier(hi), M.from_carrier(torch.randint(
                0, 1 << 32, hi.shape, dtype=torch.int64, device=dev,
                generator=gen)))
        else:
            x = (hi % field.p).to(torch.int32)
        del hi
        for key, cp in passes.items():
            tag = f"tall_{name}_{key}"
            y = cp(x)
            h = hashlib.sha256()
            for v in (y if gl else (y,)):
                h.update(v.cpu().numpy())
            out["tall_hashes"][tag] = h.hexdigest()
            a = phase(x, cp, "A")
            for ph, v in (("A", x), ("B", a)):
                out[f"{tag}_{ph}_us_per_call"] = time_device(
                    lambda _, v=v, ph=ph, cp=cp: phase(v, cp, ph), v,
                    iters=5, repeats=5)["us_per_iter"]
            out[f"{tag}_us_per_call"] = time_device(
                lambda _, cp=cp: cp(x), x, iters=5, repeats=5)["us_per_iter"]
            del y, a
        del passes, x
        torch.cuda.empty_cache()
    return out


def _sleep_ahead_us(fn, x, *, iters=20, repeats=3, cycles=20_000_000):
    """Device us a call of fn(x), the host's enqueue hidden: `iters` calls
    enqueued behind a sleep kernel (torch.cuda._sleep) and timed between
    two CUDA events recorded after it, the median of `repeats`. Returns (us,
    whether every repeat's enqueue finished inside the sleep)."""
    import time

    import torch

    fn(x)
    torch.cuda.synchronize()
    runs, hidden = [], True
    for _ in range(repeats):
        e0, start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
        e0.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        hidden = hidden and enqueue_ms < e0.elapsed_time(start)
        runs.append(start.elapsed_time(end) * 1e3 / iters)
    return sorted(runs)[len(runs) // 2], hidden


def _measure_limit() -> dict:
    """The BabyBear fold plan's cp1 (DIF, 'post_t' of random canonical
    values, transpose_out) and icp1 (DIT, canonicalize) at LIMIT_SHAPES,
    B = 1, under montgomery: each pass as one whole-column launch and
    through its tall route (colpass.tall_phases, whichever route the
    root's launch_plan gives the pass), us per call of the pass and of
    each launch, the two routes' outputs compared bit for bit, and
    kernel_info of each route; and Goldilocks's (_measure_gl_limit)."""
    import dataclasses

    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.utils.timing import time_device

    dev = torch.device("cuda", 0)
    field = T.P_2013265921
    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {"limit_equal": {}, "limit_kernel_info": {}}
    for nn, ncols in LIMIT_SHAPES:
        wmat = rng.integers(0, field.p, (ncols, nn), dtype=np.uint64)
        passes = {
            "cp1": C.make_colpass(field, nn, direction="dif", wmat=wmat,
                                  transpose_out=True, reduction="montgomery",
                                  device=dev),
            "icp1": C.make_colpass(field, nn, direction="dit",
                                   inverse_tw=True, canonicalize=True,
                                   reduction="montgomery", device=dev)}
        del wmat
        x = torch.randint(0, field.p, (1, nn, ncols), dtype=torch.int64,
                          device=dev, generator=gen).to(torch.int32)
        for key, cp in passes.items():
            tag = f"limit_{nn}_{key}"
            routes = {"whole": dataclasses.replace(cp, tall=None),
                      "tall": dataclasses.replace(
                          cp, tall=cp.tall or C.tall_phases(cp))}
            ys = {}
            for route, c in routes.items():
                ys[route] = C.colpass(x, c)
                out[f"{tag}_{route}_us_per_call"] = time_device(
                    lambda _, c=c: C.colpass(x, c), x, iters=5,
                    repeats=5)["us_per_iter"]
                out["limit_kernel_info"][f"{tag}_{route}"] = C.kernel_info(
                    c, ncols)
            out["limit_equal"][tag] = bool(torch.equal(ys["whole"],
                                                       ys["tall"]))
            u = x
            for launch in C.launch_plan(routes["tall"], ncols):
                suffix = launch["key"].rpartition("+tall")[2]
                out[f"{tag}_tall{suffix}_us_per_call"] = time_device(
                    lambda _, u=u, launch=launch: C.colpass_launch(
                        u, routes["tall"], launch), u, iters=5,
                    repeats=5)["us_per_iter"]
                u = C.colpass_launch(u, routes["tall"], launch)
            del ys, u
        del passes, x
        torch.cuda.empty_cache()
    _measure_gl_limit(out, rng, gen)
    return out


@contextlib.contextmanager
def _patched(module, **values):
    """module's attributes set to values inside the block (a reading's
    forced tile width or route), restored after it."""
    old = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def _measure_gl_limit(out: dict, rng, gen) -> None:
    """Goldilocks's cp1 (DIF, 'post_t' of random canonical values,
    transpose_out) and icp1 (DIT) at GL_LIMIT_SHAPES, B = 1, each as one
    whole-column launch at every tile width GL_TILE_COLS a block's shared
    memory takes and through its tall route (colpass.tall_phases); and the
    factored arm's cp1 (DIF, transpose_out) and icp1 (DIT) at
    GL_SHORT_SHAPES on the column tile and, where the root's package has
    it, on the short kernel (colpass.SHORT_ROWS). us per call, every
    route's output compared bit for bit with the first's, and kernel_info
    of each route, into out (_measure_limit's)."""
    import dataclasses

    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.ops import modops as M
    from ntt_aie_tpu_torch.utils.timing import time_device

    dev = torch.device("cuda", 0)
    field = T.GOLDILOCKS
    tile_cols = C.tile_cols

    def planes(nn, ncols):
        hi = torch.randint(0, (1 << 32) - 1, (1, nn, ncols),
                           dtype=torch.int64, device=dev, generator=gen)
        return (M.from_carrier(hi), M.from_carrier(torch.randint(
            0, 1 << 32, hi.shape, dtype=torch.int64, device=dev,
            generator=gen)))

    def forced(tl):
        return lambda nn, ncols, itemsize=4: (
            min(tl, ncols) if itemsize == 8 else tile_cols(nn, ncols,
                                                           itemsize))

    def read(tag, routes, x, ncols):
        ys = {}
        for route, (cp, patch) in routes.items():
            with _patched(C, **patch):
                ys[route] = G.gl_colpass(x, cp)
                out[f"{tag}_{route}_us_per_call"] = time_device(
                    lambda _, cp=cp: G.gl_colpass(x, cp), x, iters=5,
                    repeats=5)["us_per_iter"]
                out["limit_kernel_info"][f"{tag}_{route}"] = G.kernel_info(
                    cp, ncols)
        first = next(iter(ys.values()))
        out["limit_equal"][tag] = all(
            torch.equal(a, b) for y in ys.values() for a, b in zip(first, y))

    for nn, ncols in GL_LIMIT_SHAPES:
        wmat = rng.integers(0, 1 << 63, (ncols, nn), dtype=np.uint64)
        passes = {"cp1": G.make_gl_colpass(field, nn, direction="dif",
                                           wmat=wmat, transpose_out=True,
                                           device=dev),
                  "icp1": G.make_gl_colpass(field, nn, direction="dit",
                                            inverse_tw=True, device=dev)}
        del wmat
        x = planes(nn, ncols)
        for key, cp in passes.items():
            whole = dataclasses.replace(cp, tall=None)
            routes = {f"whole_tl{tl}": (whole, {"tile_cols": forced(tl)})
                      for tl in GL_TILE_COLS if nn * tl * 8 <= 131072}
            routes["tall"] = (dataclasses.replace(
                cp, tall=cp.tall or C.tall_phases(cp)), {})
            read(f"limit_gl_{nn}x{ncols}_{key}", routes, x, ncols)
        del passes, x
        torch.cuda.empty_cache()
    for nn, ncols in GL_SHORT_SHAPES:
        passes = {"cp1": G.make_gl_colpass(field, nn, direction="dif",
                                           transpose_out=True, device=dev),
                  "icp1": G.make_gl_colpass(field, nn, direction="dit",
                                            inverse_tw=True, device=dev)}
        x = planes(nn, ncols)
        for key, cp in passes.items():
            routes = {"tile": (cp, {"SHORT_ROWS": 1}
                               if hasattr(C, "SHORT_ROWS") else {})}
            if hasattr(C, "SHORT_ROWS"):
                routes["short"] = (cp, {"SHORT_ROWS": GL_SHORT_SHAPES[-1][0]})
            read(f"limit_gl_{nn}x{ncols}_{key}", routes, x, ncols)
        del passes, x
        torch.cuda.empty_cache()


def _measure_steps() -> dict:
    """The fused plan against the fold plan at STEP_CASES: us per call of
    fwd_mat and inv_mat of each (on CUDA events, each call on the same
    input), the fused transforms' device us alone (_sleep_ahead_us), the
    fused fwd_mat compared with the fold's bit for bit, kernel_info of the
    fused transforms."""
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import fused_fourstep as F
    from ntt_aie_tpu_torch.utils.timing import time_device

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(9)
    out = {"steps_equal": {}, "steps_kernel_info": {}}
    for name, log_n, rows_log2, batch in STEP_CASES:
        field = T.FIELDS[name]
        cfg = T.NTTConfig(field=field, log_n=log_n, rows_log2=rows_log2)
        n1, n2 = cfg.split
        tag = f"steps_{name}_{n1}x{n2}_b{batch}"
        fold = T.build_plan(cfg, device=dev)
        fused = T.build_plan(cfg, device=dev, fused=True)
        bats = {"fold": fold.make_batched(batch),
                "fused": fused.make_batched(batch)}
        x = torch.randint(0, field.p, (batch, n1, n2), dtype=torch.int64,
                          device=dev, generator=gen).to(torch.int32)
        y = bats["fold"]["fwd_mat"](x)
        out["steps_equal"][tag] = bool(torch.equal(
            y, bats["fused"]["fwd_mat"](x)))
        for plan_name, bat in bats.items():
            for key, v in (("fwd_mat", x), ("inv_mat", y)):
                out[f"{tag}_{plan_name}_{key}_us_per_call"] = time_device(
                    lambda _, key=key, v=v, bat=bat: bat[key](v), v,
                    iters=5, repeats=5)["us_per_iter"]
        for key, v in (("ff", x), ("fi", y)):
            ff = fused.passes[key]
            us, hidden = _sleep_ahead_us(lambda u, ff=ff: F.fused_fourstep(
                u, ff), v)
            out[f"{tag}_{key}_device_us_per_call"] = us
            out[f"{tag}_{key}_enqueue_hidden"] = hidden
            out["steps_kernel_info"][f"{tag}_{key}"] = F.kernel_info(
                ff, batch)
        del fold, fused, bats, x, y
        torch.cuda.empty_cache()
    return out


def _measure_split() -> dict:
    """The split passes at B = 1: each launch of SPLIT_PLANS' passes and
    of SPLIT_PASSES alone (us per call, each launch on the output of the
    one before it), the passes' output hashes and kernel_info, and the
    plans' callables (us per call; a fused plan's ff also on the device
    alone, _sleep_ahead_us)."""
    import hashlib

    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import fused_fourstep as F
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.ops import modops as M
    from ntt_aie_tpu_torch.utils.timing import time_device

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {"split_hashes": {}, "split_kernel_info": {}}

    def values(field, shape):
        if field.is_goldilocks:  # (hi, lo), hi below 2^32 - 1: below p
            return tuple(M.from_carrier(torch.randint(
                0, top, shape, dtype=torch.int64, device=dev,
                generator=gen)) for top in ((1 << 32) - 1, 1 << 32))
        return torch.randint(0, field.p, shape, dtype=torch.int64,
                             device=dev, generator=gen).to(torch.int32)

    def time_call(fn):
        return time_device(lambda _: fn(), torch.empty(0, device=dev),
                           iters=5, repeats=5)["us_per_iter"]

    def read_pass(tag, cp, field, ncols):
        gl = field.is_goldilocks
        mod = G if gl else C
        run = G.gl_colpass_launch if gl else C.colpass_launch
        x = values(field, (1, cp.nn, ncols))
        u = x
        for launch in C.launch_plan(cp, ncols, itemsize=8 if gl else 4):
            suffix = launch["key"].rpartition("+tall")[2]
            out[f"{tag}_{suffix}_us_per_call"] = time_call(
                lambda u=u, launch=launch: run(u, cp, launch))
            u = run(u, cp, launch)
        h = hashlib.sha256()
        for v in (u if gl else (u,)):
            h.update(v.cpu().numpy())
        out["split_hashes"][tag] = h.hexdigest()
        out[f"{tag}_us_per_call"] = time_call(lambda: cp(x))
        out["split_kernel_info"][tag] = mod.kernel_info(cp, ncols)

    for tag, name, log_n, rows_log2, kw, passes, calls in SPLIT_PLANS:
        field = T.FIELDS[name]
        cfg = T.NTTConfig(field=field, log_n=log_n, rows_log2=rows_log2)
        n1, n2 = cfg.split
        plan = T.build_plan(cfg, device=dev, **kw)
        for key in passes:
            read_pass(f"split_{tag}_{key}", plan.passes[key], field, n1)
        bat = plan.make_batched(1)
        x = values(field, (1, n1, n2))
        for key in calls:
            fn = bat[key]
            out[f"split_{tag}_{key}_us_per_call"] = time_call(
                (lambda fn=fn: fn(x, x)) if key == "polymul_mat"
                else (lambda fn=fn: fn(x)))
        if kw.get("fused"):
            ff = plan.passes["ff"]
            us, hidden = _sleep_ahead_us(
                lambda u, ff=ff: F.fused_fourstep(u, ff), x)
            out[f"split_{tag}_ff_device_us_per_call"] = us
            out[f"split_{tag}_ff_enqueue_hidden"] = hidden
            out["split_kernel_info"][f"split_{tag}_ff"] = F.kernel_info(ff,
                                                                        1)
        del plan, bat, x
        torch.cuda.empty_cache()
    for tag, name, nn, ncols in SPLIT_PASSES:
        field = T.FIELDS[name]
        if field.is_goldilocks:
            cp = G.make_gl_colpass(field, nn, direction="dif", device=dev)
        else:
            cp = C.make_colpass(field, nn, direction="dif", canonicalize=True,
                                reduction="montgomery", device=dev)
        read_pass(f"split_{tag}_cp2", cp, field, ncols)
        del cp
        torch.cuda.empty_cache()
    return out


def _measure_pointwise() -> dict:
    """POINTWISE_CASES' fold and fused plans: ``Plan.pointwise`` of two
    spectra alone, ``fwd_mat``, ``inv_mat`` and ``polymul_mat`` (of x with
    itself), and under harvey4 the matrix-form example's cached loop
    (``serving_matform_demo.serve`` against cached spectra), us per NTT;
    hashes of the product's and of polymul_mat's bits (equal across every
    reading of every root: the products are exact); the pointwise
    kernel's launches per call where the root has one."""
    import hashlib

    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch import ops
    from ntt_aie_tpu_torch.examples import serving_matform_demo as SM
    from ntt_aie_tpu_torch.utils.timing import time_device

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    out = {"pointwise_hashes": {}, "pointwise_launches": {}}

    def digest(t):  # the first 2^24 values (64 MB)
        return hashlib.sha256(t.reshape(-1)[:1 << 24].cpu().numpy()
                              ).hexdigest()

    for kind, name, log_n, rows_log2, batch in POINTWISE_CASES:
        field = T.FIELDS[name]
        cfg = T.NTTConfig(field=field, log_n=log_n, rows_log2=rows_log2,
                          reduction=kind)
        n1, n2 = cfg.split
        x, k = (torch.randint(0, field.p, (batch, n1, n2), dtype=torch.int32,
                              device=dev, generator=gen) for _ in range(2))
        for arm in ("fold", "fused"):
            plan = T.build_plan(cfg, device=dev, fused=arm == "fused")
            bat = plan.make_batched(batch)
            k_spec = bat["fwd_mat"](k)
            fns = {"fwd_mat": bat["fwd_mat"], "inv_mat": bat["inv_mat"],
                   "polymul_mat": lambda v: bat["polymul_mat"](v, v)}
            if arm == "fold":
                fns["pointwise"] = lambda v: plan.pointwise(v, k_spec)
                out["pointwise_hashes"][kind] = digest(
                    plan.pointwise(bat["fwd_mat"](x), k_spec))
                if kind == "harvey4":
                    fns["cached_loop"] = lambda v: SM.serve(
                        bat, plan.pointwise, k_spec, v)
            out["pointwise_hashes"][f"{kind}_{arm}_polymul_mat"] = digest(
                bat["polymul_mat"](x, k))
            counters = ops.launch_counters()
            if "pointwise32" in counters:
                for key in ("polymul_mat", "pointwise"):
                    if key not in fns:
                        continue
                    ops.reset_launches()
                    fns[key](x)
                    torch.cuda.synchronize()
                    out["pointwise_launches"][f"{kind}_{arm}_{key}"] = {
                        k_: v for k_, v in ops.read_launches().items() if v}
            for key, fn in fns.items():
                us = time_device(fn, x)["us_per_iter"]
                out[f"pw_{kind}_{arm}_{key}_us_per_ntt"] = us / batch
            del plan, bat, k_spec, fns
            torch.cuda.empty_cache()
    return out


def _measure_sync() -> dict:
    """Device us a cooperative launch of SYNC_STEPS empty steps
    (scripts/grid_sync.cu, built here with the package's nvcc flags) at
    SYNC_BLOCKS_PER_SM blocks an SM, and one grid sync's cost, the slope
    between the shortest and the longest list."""
    import ctypes
    import hashlib

    import torch
    from torch.utils.cpp_extension import CUDA_HOME

    from ntt_aie_tpu_torch.ops import colpass as C

    src = pathlib.Path(__file__).with_name("grid_sync.cu")
    key = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = C.BUILD_DIR / f"grid_sync-{key}.so"
    if not so.exists():
        C.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
        subprocess.run([os.path.join(CUDA_HOME or "/usr/local/cuda", "bin",
                                     "nvcc"), *C.NVCC_FLAGS, "-o", str(tmp),
                        str(src)], check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.grid_sync_steps.restype = ctypes.c_int
    lib.grid_sync_steps.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
    lib.grid_sync_error_string.restype = ctypes.c_char_p
    dev = torch.device("cuda", 0)
    grid = (SYNC_BLOCKS_PER_SM
            * torch.cuda.get_device_properties(dev).multi_processor_count)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {"sync_grid": grid}
    for k in SYNC_STEPS:
        counters = torch.zeros(k, dtype=torch.int32, device=dev)

        def launch(_, k=k, c=counters):
            err = lib.grid_sync_steps(c.data_ptr(), k, grid, stream)
            if err:
                raise RuntimeError(lib.grid_sync_error_string(err).decode())

        out[f"sync_{k}_steps_device_us_per_call"] = _sleep_ahead_us(
            launch, counters)[0]
    lo, hi = SYNC_STEPS[0], SYNC_STEPS[-1]
    out["sync_us"] = ((out[f"sync_{hi}_steps_device_us_per_call"]
                       - out[f"sync_{lo}_steps_device_us_per_call"])
                      / (hi - lo))
    return out


def _measure_nested() -> dict:
    """The column pass and the nested pass at fuse 1 to 5 at the nested
    bench shape, us per call."""
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import nested_colpass as N
    from ntt_aie_tpu_torch.utils.timing import time_device

    dev = torch.device("cuda", 0)
    field = T.P_469762049
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randint(0, field.p, (NESTED_BATCH, NESTED_N, NESTED_N),
                      dtype=torch.int32, device=dev, generator=gen)
    cp = C.make_colpass(field, NESTED_N, direction="dif", device=dev)
    out = {"nested_kernel_info": {},
           "colpass_b64_us_per_call": time_device(cp, x)["us_per_iter"]}
    for fuse in NESTED_FUSE:
        nc, _ = N.make_nested_colpass(NESTED_N, NESTED_N, batch=NESTED_BATCH,
                                      fuse=fuse, device=dev)
        out[f"nested_fuse{fuse}_us_per_call"] = time_device(
            nc, x)["us_per_iter"]
        if fuse == 3:
            out["nested_equals_colpass"] = bool(torch.equal(nc(x), cp(x)))
        if hasattr(N, "kernel_info"):
            out["nested_kernel_info"][fuse] = N.kernel_info(nc)
    return out


def _measure(reduction: str = "harvey4") -> dict:
    """One reading of the imported package (the child's work)."""
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.utils.timing import time_device

    dev = torch.device("cuda", 0)
    field = T.FIELDS[REDUCTION_FIELDS[reduction]]
    cfg = T.NTTConfig(field=field, log_n=LOG_N, reduction=reduction)
    n1, n2 = cfg.split
    fused = T.build_plan(cfg, device=dev, fused=True)
    fold = T.build_plan(cfg, device=dev)
    batch = BATCH
    fused_b, fold_b = fused.make_batched(batch), fold.make_batched(batch)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, field.p, (batch, n1, n2), dtype=torch.int32,
                      device=dev, generator=gen)
    equal = bool(torch.equal(fused_b["fwd_mat"](x), fold_b["fwd_mat"](x)))
    out = {"package": str(pathlib.Path(T.__file__).parent), "batch": batch,
           "fused_equals_fold": equal}
    for name, bat in (("fused", fused_b), ("fold", fold_b)):
        for key in ("fwd_mat", "inv_mat"):
            us = time_device(bat[key], x)["us_per_iter"]
            out[f"{name}_{key}_us_per_ntt"] = us / batch
    # cp2 takes (B, n2, n1): x's shape, as n = 2^20 splits 1024 x 1024
    for key in ("cp1", "cp2"):
        us = time_device(fold.passes[key], x)["us_per_iter"]
        out[f"fold_{key}_us_per_ntt"] = us / batch
    if hasattr(C, "kernel_info"):
        out["colpass_kernel_info"] = {
            key: C.kernel_info(fold.passes[key], x.shape[2])
            for key in ("cp1", "cp2")}
    return out


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", default=[],
                    metavar="NAME=DIR", help="another checkout to time")
    ap.add_argument("--nested", action="store_true",
                    help="also time the nested pass at fuse 1-5 and the "
                         "column pass at B = 64, 1024 x 1024")
    ap.add_argument("--gl", action="store_true",
                    help="also time the Goldilocks fold plan and its cp1 "
                         "and cp2 at B = 64, n = 2^20")
    ap.add_argument("--crt", action="store_true",
                    help="also time the CRT combine of 16 RNS products of "
                         "n = 2^20")
    ap.add_argument("--ring", action="store_true",
                    help="also time the ML-KEM / ML-DSA transforms and "
                         "polymul at B = 8,192 and their serving steps at "
                         "B = 1,024")
    ap.add_argument("--tall", action="store_true",
                    help="also time the tall route's launches at the "
                         "8192 x 16384 split of n = 2^27, B = 1 (roots "
                         "with the route)")
    ap.add_argument("--limit", action="store_true",
                    help="also time BabyBear cp1 and icp1 at 8192 x 16384 "
                         "and 4096 x 32768, B = 1, as one whole-column "
                         "launch and through the tall route")
    ap.add_argument("--steps", action="store_true",
                    help="also time the fused plan's step lists against "
                         "the fold plan at BabyBear n = 2^27, (1, 2^20) "
                         "and n = 2^17 (8 x 16384, 16384 x 8)")
    ap.add_argument("--split", action="store_true",
                    help="also time each launch of the split passes at "
                         "B = 1: BabyBear (1, 2^27), Goldilocks (2, 2^27) "
                         "factored, (2, 2^26), (4, 2^26), GL (1, 2^27) and "
                         "GL (4, 2^26) cp2")
    ap.add_argument("--pointwise", action="store_true",
                    help="also time the 32-bit pointwise product, the "
                         "fold and fused plans' fwd_mat, inv_mat and "
                         "polymul_mat (harvey4, harvey, montgomery at "
                         "n = 2^20, B = 256; barrett on Kyber at B = "
                         "16,384) and the matrix-form cached loop")
    ap.add_argument("--sync", action="store_true",
                    help="only time the grid sync (scripts/grid_sync.cu) "
                         "and print one line")
    ap.add_argument("--reduction", default="harvey4",
                    choices=sorted(REDUCTION_FIELDS),
                    help="the reduction (and its field) of the transforms")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.sync:
        _emit(dict(_measure_sync(), card=_card(),
                   method="CUDA events around 20 launches enqueued behind "
                          "a sleep kernel, median of 3"))
        return 0
    if args.child:
        reading = _measure(args.reduction)
        if args.nested:
            reading.update(_measure_nested())
        if args.gl:
            reading.update(_measure_gl())
        if args.crt:
            reading.update(_measure_crt())
        if args.ring:
            reading.update(_measure_ring())
        if args.tall:
            from ntt_aie_tpu_torch.ops import colpass as C

            if hasattr(C, "colpass_phase"):
                reading.update(_measure_tall())
        if args.limit:
            reading.update(_measure_limit())
        if args.steps:
            reading.update(_measure_steps())
        if args.split:
            reading.update(_measure_split())
        if args.pointwise:
            reading.update(_measure_pointwise())
        _emit(reading)
        return 0

    roots = {}
    for spec in args.root:
        name, _, path = spec.partition("=")
        if not path or not (pathlib.Path(path) / "ntt_aie_tpu_torch").is_dir():
            ap.error(f"--root {spec}: not NAME=DIR of a checkout")
        roots[name] = pathlib.Path(path).resolve()
    roots["this"] = THIS_ROOT

    libs = (("colpass", "fused_fourstep") + ("nested_colpass",) * args.nested
            + ("gl_colpass",) * (args.gl or args.tall or args.limit
                                 or args.split)
            + ("crt",) * args.crt
            + ("ring_layers",) * args.ring
            + ("pointwise",) * args.pointwise)
    reds = {args.reduction} | ({"montgomery"} if args.tall or args.limit
                               or args.steps or args.split else set())
    if args.pointwise:
        reds |= {kind for kind, *_ in POINTWISE_CASES}
    reds = sorted(reds - {"harvey4"})
    # a root without a library's source (an older commit) skips its build
    build = ("from ntt_aie_tpu_torch.ops import colpass as C; "
             f"[C.build_library(n) for n in {libs!r} "
             "if (C.CSRC_DIR / f'{n}.cu').exists()]; "
             f"[C.build_library(n, r) for r in {reds!r} for n in "
             "('colpass', 'fused_fourstep')]")
    with concurrent.futures.ThreadPoolExecutor(len(roots)) as pool:
        builds = {name: pool.submit(  # cwd: -c puts it first on sys.path
            subprocess.run, [sys.executable, "-c", build], cwd=root,
            env=dict(os.environ, PYTHONPATH=str(root)), capture_output=True,
            text=True) for name, root in roots.items()}
        for name, fut in builds.items():
            res = fut.result()
            if res.returncode != 0:
                _emit({"root": name, "ok": False, "error": res.stderr[-2000:]})
                return 1

    order = list(roots) + list(reversed(roots))
    readings = {name: [] for name in roots}
    flags = (["--nested"] * args.nested + ["--gl"] * args.gl
             + ["--crt"] * args.crt + ["--ring"] * args.ring
             + ["--tall"] * args.tall + ["--limit"] * args.limit
             + ["--steps"] * args.steps + ["--split"] * args.split
             + ["--pointwise"] * args.pointwise
             + ["--reduction", args.reduction])
    ok = True
    gl_hashes = crt_hash = ring_hashes = tall_hashes = split_hashes = None
    pw_hashes = None
    for name in order:
        res = _run_child(roots[name], flags)
        if res.returncode != 0:
            _emit({"root": name, "ok": False, "error": res.stderr[-2000:]})
            return 1
        reading = json.loads(res.stdout.strip().splitlines()[-1])
        gl_hashes = gl_hashes or reading.get("gl_hashes")
        crt_hash = crt_hash or reading.get("crt_hash")
        ring_hashes = ring_hashes or reading.get("ring_hashes")
        tall_hashes = tall_hashes or reading.get("tall_hashes")
        split_hashes = split_hashes or reading.get("split_hashes")
        pw_hashes = pw_hashes or reading.get("pointwise_hashes")
        ok = (ok and reading["fused_equals_fold"]
              and reading.get("nested_equals_colpass", True)
              and reading.get("gl_hashes") == gl_hashes
              and reading.get("crt_hash") == crt_hash
              and reading.get("ring_hashes") == ring_hashes
              and reading.get("tall_hashes", tall_hashes) == tall_hashes
              and reading.get("split_hashes") == split_hashes
              and reading.get("pointwise_hashes") == pw_hashes
              and all(reading.get("limit_equal", {}).values())
              and all(reading.get("steps_equal", {}).values()))
        readings[name].append(reading)
        _emit(dict(reading, root=name))

    keys = [k for k in readings["this"][0]
            if k.endswith(("_us_per_ntt", "_us_per_call"))]
    summary = {name: {k: sum(r[k] for r in rs) / len(rs) for k in keys
                      if all(k in r for r in rs)}
               for name, rs in readings.items()}
    _emit({"summary": summary, "card": _card(), "batch": BATCH,
           "reduction": args.reduction,
           "nested_batch": NESTED_BATCH if args.nested else None,
           "gl_batch": GL_BATCH if args.gl else None,
           "ring_batch": ([RING_BATCH, RING_SERVING_BATCH] if args.ring
                          else None),
           "gl_outputs_agree": (all(r.get("gl_hashes") == gl_hashes
                                    for rs in readings.values() for r in rs)
                                if args.gl else None),
           "order": order, "ok": ok,
           "method": "one child process a reading; CUDA events, 5 repeats "
                     "of a dependent chain of 10, trimmed mean; us per NTT "
                     "= us per call / batch (the nested bench shape's in "
                     "us per call); each root's mean over its readings"})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
