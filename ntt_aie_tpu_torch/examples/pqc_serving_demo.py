"""Batched post-quantum serving: ML-KEM and ML-DSA module-lattice
arithmetic on the device.

Port of the reference's ``examples/pqc_serving_demo.py``. The serving
loop of both FIPS standards is NTT -> NTT-domain matrix-vector product ->
inverse NTT (K-PKE encrypt computes u = A^T r, ML-DSA Sign w = A y). This
demo runs a batch of those products through each scheme's pipeline (its
transforms one launch each of ``csrc/ring_layers.cu`` on the card) and
holds one lane against the schoolbook oracle.

    python -m ntt_aie_tpu_torch.examples.pqc_serving_demo [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from ntt_aie_tpu_torch import dilithium as DL
from ntt_aie_tpu_torch import kyber as KY
from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch.examples import parse_args, report, require

BATCH = 64


def _check_one(A, s, got, q, label) -> str:
    """One lane's first output polynomial, sum_j A[0, j] * s[j] in
    Z_q[X]/(X^256 + 1), against the schoolbook product."""
    want = np.zeros(256, dtype=np.int64)
    for j in range(A.shape[1]):
        want = (want + ref.schoolbook_negacyclic(A[0, j], s[j], q)
                .astype(np.int64)) % q
    require(np.array_equal(got.cpu().numpy().astype(np.int64), want), label)
    return f"{label}: device == schoolbook oracle ✓"


def run(batch: int = BATCH, *, device=None) -> dict:
    """The ML-KEM-512 keygen shape t = A s (k = 2) and the ML-DSA-65 sign
    shape w = A y (6 x 5) at `batch` lanes through serving_step, lane 0
    against the oracle, and ML-KEM's fixed-A serving step (one key's
    NTT-domain A against a batch of vectors) against the fresh-A result.
    Returns the inputs, the outputs (int32 tensors on the device) and
    the lines main prints."""
    rng = np.random.default_rng(0)
    ky = KY.make_pipeline(device=device)
    dl = DL.make_pipeline(device=device)
    lines = []

    # --- ML-KEM-512 shape: t = A*s, A in R_q^{2x2}, a batch of keygens ---
    k = 2
    A = rng.integers(0, KY.Q, (batch, k, k, 256), dtype=np.uint32)
    s = rng.integers(0, KY.Q, (batch, k, 256), dtype=np.uint32)
    t = ky["serving_step"](A, s)
    lines.append(_check_one(A[0], s[0], t[0, 0], KY.Q,
                            f"ML-KEM t=A*s (k={k}, B={batch})"))

    # --- ML-DSA-65 shape: w = A*y, A in R_q^{6x5}, a batch of signatures ---
    kk, ll = 6, 5
    A2 = rng.integers(0, DL.Q, (batch, kk, ll, 256), dtype=np.uint32)
    y = rng.integers(0, DL.Q, (batch, ll, 256), dtype=np.uint32)
    w = dl["serving_step"](A2, y)
    lines.append(_check_one(A2[0], y[0], w[0, 0], DL.Q,
                            f"ML-DSA w=A*y (k={kk}, l={ll}, B={batch})"))

    # Fixed-A serving form: one key's NTT-domain matrix reused across
    # vector batches (what a KEM or signing service runs).
    step = ky["make_serving_step"](ky["ntt"](A[0]))
    t0 = step(s[:8])
    require(np.array_equal(t0[0].cpu().numpy(), t[0].cpu().numpy()),
            "fixed-A serving step mismatch")
    lines.append("ML-KEM fixed-A serving step: matches fresh-A pipeline ✓")
    return {"batch": batch, "A": A, "s": s, "t": t, "A2": A2, "y": y,
            "w": w, "t_fixed": t0, "lines": lines}


def main(argv=None) -> int:
    args = parse_args(argv, __doc__)
    return report(run(device=args.device))


if __name__ == "__main__":
    sys.exit(main())
