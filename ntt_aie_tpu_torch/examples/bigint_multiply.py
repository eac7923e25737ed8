"""Multiply two big integers exactly with the RNS NTT product.

Port of the reference's ``examples/bigint_multiply.py``. An integer is a
polynomial in base 2^16 evaluated at x = 2^16; the product polynomial's
coefficients (exact through RNS and the CRT combine, ``RNSPolymul``)
carry back into an integer, held against Python's own product. Up to
4,096 bits the ring is on the flat split; 2^20 bits take n = 2^17, a
four-step split and the matrix-form products.

    python -m ntt_aie_tpu_torch.examples.bigint_multiply [bits] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from ntt_aie_tpu_torch.examples import parse_args, report, require
from ntt_aie_tpu_torch.rns import RNSPolymul

BASE_BITS = 16


def int_to_coeffs(x: int, n: int) -> np.ndarray:
    """The n base-2^16 digits of x >= 0, least significant first."""
    raw = x.to_bytes(n * BASE_BITS // 8, "little")
    return np.frombuffer(raw, dtype="<u2").astype(np.int64)


def coeffs_to_int(c) -> int:
    """sum c[i] * 2^(16 i) over exact integer coefficients, joined in
    pairs level by level (carries ride Python's integers)."""
    parts, width = [int(v) for v in c], BASE_BITS
    while len(parts) > 1:
        if len(parts) % 2:
            parts.append(0)
        parts = [parts[i] + (parts[i + 1] << width)
                 for i in range(0, len(parts), 2)]
        width *= 2
    return parts[0] if parts else 0


def run(bits: int = 4096, *, device=None) -> dict:
    """x * y for two random `bits`-bit integers through RNSPolymul at the
    smallest n that holds the whole product, checked exactly. Returns the
    operands, their digit vectors, the product's coefficients (object
    ints), the product and the lines main prints."""
    rng = np.random.default_rng(0)
    x = int.from_bytes(rng.bytes(bits // 8), "little")
    y = int.from_bytes(rng.bytes(bits // 8), "little")

    digits = -(-bits // BASE_BITS)  # ceil: a partial top limb counts
    log_n = (2 * digits - 1).bit_length()  # room for the whole product
    rns = RNSPolymul(log_n, device=device)
    require(rns.max_input_bound() >= (1 << BASE_BITS) - 1,
            "the RNS modulus cannot hold base-2^16 digit products")

    xd, yd = int_to_coeffs(x, 1 << log_n), int_to_coeffs(y, 1 << log_n)
    coeffs = rns.polymul(xd, yd)
    got = coeffs_to_int(coeffs)
    require(got == x * y, f"{bits}-bit multiply: mismatch")
    return {"bits": bits, "log_n": log_n, "x": x, "y": y, "x_digits": xd,
            "y_digits": yd, "coeffs": coeffs, "product": got,
            "lines": [f"{bits}-bit x {bits}-bit multiply via n=2^{log_n} "
                      "RNS NTT: exact ✓"]}


def main(argv=None) -> int:
    args = parse_args(argv, __doc__, ("bits", int, 4096))
    return report(run(args.bits, device=args.device))


if __name__ == "__main__":
    sys.exit(main())
