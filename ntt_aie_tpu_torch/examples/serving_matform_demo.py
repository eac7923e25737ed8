"""Matrix-form serving: keep polynomials in the transform's natural
(B, n1, n2) tiling between operations, against a cache of spectra.

Port of the reference's ``examples/serving_matform_demo.py``. The loop
stays in matrix form because the four-step transform's own layout is
(n1, n2) in and (n2, n1) out, so a flat (B, n) view is needed only at the
edge of the system. A kernel polynomial is transformed once (the spectral
cache); each request is then its messages' forward transform, the
pointwise product against the cached spectra and the inverse:
``inv_mat(pointwise(fwd_mat(m), k_spec))``, two transforms where
``polymul_mat`` runs three. Every step is held against the host oracle,
and the loop's output against ``polymul_mat``'s, bit for bit.

    python -m ntt_aie_tpu_torch.examples.serving_matform_demo [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch.api import NTTContext
from ntt_aie_tpu_torch.config import NTTConfig
from ntt_aie_tpu_torch.examples import parse_args, report, require
from ntt_aie_tpu_torch.fields import P_469762049 as FIELD

N_LOG2 = 12
B = 4


def serve(bat: dict, pointwise, k_spec, m2d):
    """One request through the cached loop: the (B, n1, n2) messages'
    spectra times the cached (B, n2, n1) spectra k_spec, transformed back
    to the (B, n1, n2) natural layout. bat is make_batched(B)'s callables,
    pointwise the plan's spectral product (Plan.pointwise)."""
    return bat["inv_mat"](pointwise(bat["fwd_mat"](m2d), k_spec))


def run(log_n: int = N_LOG2, batch: int = B, *, device=None,
        oracle_rows=None) -> dict:
    """The serving loop at n = 2^log_n (the square four-step split) over a
    batch of `batch` message and kernel polynomials. Checks: the rows
    `oracle_rows` of the output (None: every row, as the reference)
    against reference.cyclic_polymul; the output equal to polymul_mat's
    on every row; the cached spectra equal to the flat forward's; the
    unbatched polymul_mat of row 0 equal to row 0. Returns the host
    inputs, the device outputs, the context and the lines main prints."""
    cfg = NTTConfig(field=FIELD, log_n=log_n, rows_log2=log_n // 2)
    n1, n2 = cfg.split
    ctx = NTTContext(cfg, device=device)
    bat = ctx.make_batched(batch)  # the documented serving surface
    rng = np.random.default_rng(0)
    msgs, kern = (rng.integers(0, FIELD.p, (batch, cfg.n), dtype=np.uint32)
                  for _ in range(2))

    # a host-side reshape is free: upload in the matrix layout
    m2d, k2d = (torch.from_numpy(v.reshape(batch, n1, n2).view(np.int32))
                .to(ctx.device) for v in (msgs, kern))

    # 1. spectral cache: one forward a kernel, reused across requests
    k_spec = bat["fwd_mat"](k2d)                       # (B, n2, n1)

    # 2. serving loop: a request is fwd -> pointwise against the cached
    #    spectra -> inv, all in matrix form (no flat boundary anywhere)
    out2d = serve(bat, ctx.plan.pointwise, k_spec, m2d)  # (B, n1, n2)

    # 3. edge of the system: flatten once (row-major = the flat contract)
    out = out2d.reshape(batch, cfg.n)

    rows = range(batch) if oracle_rows is None else oracle_rows
    host = out[list(rows)].cpu().numpy().astype(np.int64)
    for r, got in zip(rows, host):
        require(np.array_equal(got, ref.cyclic_polymul(msgs[r], kern[r],
                                                       FIELD)),
                f"row {r} differs from the oracle")
    # the cached loop is polymul_mat's product, bit for bit
    fused = bat["polymul_mat"](m2d, k2d)
    require(torch.equal(out2d, fused),
            "the cached loop differs from polymul_mat")
    # the cached spectra really are the flat forward's values
    flat = bat["fwd"](k2d.reshape(batch, cfg.n))
    require(torch.equal(k_spec.reshape(batch, cfg.n), flat),
            "the cached spectra differ from the flat forward")
    # the unbatched twin (the B = 1 latency path) agrees too
    one = ctx.polymul_mat(m2d[0], k2d[0])
    require(torch.equal(one.reshape(cfg.n), out[0]),
            "the unbatched polymul_mat differs from row 0")
    return {"n": cfg.n, "split": (n1, n2), "batch": batch, "msgs": msgs,
            "kern": kern, "k_spec": k_spec, "out": out, "polymul_mat": fused,
            "fwd": flat, "one": one, "context": ctx,
            "lines": [f"matrix-form serving loop (B={batch}, n=2^{log_n}): "
                      "device == oracle ✓ (cached spectra, no flat boundary "
                      "inside the loop; == polymul_mat)"]}


def main(argv=None) -> int:
    args = parse_args(argv, __doc__)
    return report(run(device=args.device))


if __name__ == "__main__":
    sys.exit(main())
