"""Negacyclic polynomial arithmetic in Z_p[X]/(X^n + 1): the RLWE ring.

Port of the reference's ``examples/rlwe_demo.py``. The product runs on
the flat split's negacyclic path, where psi^i and psi^-i ride the fused
four-step kernel as its 'pre' and 'post' operands (the plan's ``nf`` and
``ni``), and is held against the NumPy oracle.

    python -m ntt_aie_tpu_torch.examples.rlwe_demo [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch.api import NTTContext
from ntt_aie_tpu_torch.config import NTTConfig
from ntt_aie_tpu_torch.examples import parse_args, report, require
from ntt_aie_tpu_torch.fields import P_469762049 as FIELD

N_LOG2 = 10  # ring dimension 1024


def run(log_n: int = N_LOG2, *, device=None) -> dict:
    """a(X) * s(X) mod (X^n + 1, p) for a uniform a and a small secret s
    (coefficients in {0, 1, 2}), n = 2^log_n, against the oracle. Returns
    the inputs, the product (an int32 tensor on the device) and the
    lines main prints."""
    cfg = NTTConfig(field=FIELD, log_n=log_n, negacyclic=True)
    ctx = NTTContext(cfg, device=device)
    rng = np.random.default_rng(0)
    a = rng.integers(0, FIELD.p, cfg.n)
    s = rng.integers(0, 3, cfg.n)  # small "secret"

    prod = ctx.plan.negacyclic_polymul(a, s)
    want = ref.negacyclic_polymul(a, s, FIELD)
    require(np.array_equal(prod.cpu().numpy().astype(np.int64), want),
            f"a(X)*s(X) mod (X^{cfg.n}+1): the device differs from the "
            "oracle")
    return {"n": cfg.n, "a": a, "s": s, "prod": prod,
            "lines": [f"a(X)*s(X) mod (X^{cfg.n}+1, {FIELD.p}): "
                      "device == oracle ✓"]}


def main(argv=None) -> int:
    args = parse_args(argv, __doc__)
    return report(run(device=args.device))


if __name__ == "__main__":
    sys.exit(main())
