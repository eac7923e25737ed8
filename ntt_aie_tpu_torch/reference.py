"""NumPy golden oracles: textbook DIF/DIT NTTs, the cyclic and negacyclic
products, and the O(n^2) schoolbook negacyclic product.

A copy of the true-NTT half of ``ntt_aie_tpu.reference``: int64 NumPy for
32-bit word primes, Python integers (object arrays) for Goldilocks. It
shares no arithmetic with the column-pass kernels or their plain versions
(Python's ``%`` on exact integers), so it can judge both; ``chip_smoke.py``
falls back to it when the native C++ oracle cannot be built.
"""

from __future__ import annotations

import numpy as np

from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.fields import PrimeField


def _work_dtype(p: int):
    return object if p >= (1 << 31) else np.int64


def ntt_dif(a, field: PrimeField, *, inverse: bool = False) -> np.ndarray:
    """Gentleman-Sande DIF NTT: natural-order in, bit-reversed out.

    Stage s: t = n >> (s+1); reshape (blocks, 2, t); butterfly
    (u+v, (u-v) * w[jj]).
    """
    dt = _work_dtype(field.p)
    a = np.asarray(a).astype(dt).copy()
    n = len(a)
    p = field.p
    stages_tw = tw.dif_stage_twiddles(field, n, inverse=inverse)
    for s in range(n.bit_length() - 1):
        t = n >> (s + 1)
        x = a.reshape(-1, 2, t)
        u = x[:, 0, :].copy()
        v = x[:, 1, :].copy()
        wv = stages_tw[s].astype(dt).reshape(1, t)
        x[:, 0, :] = (u + v) % p
        x[:, 1, :] = ((u - v) % p) * wv % p
        a = x.reshape(n)
    return a


def ntt_dit(a, field: PrimeField, *, inverse: bool = False,
            scale: bool | None = None) -> np.ndarray:
    """Cooley-Tukey DIT NTT: bit-reversed in, natural-order out.

    Stage s: t = 2^s; butterfly (u + w[jj]*v, u - w[jj]*v). With
    inverse=True and scale (default: scale=inverse) also multiplies by
    n^-1, so ntt_dit(ntt_dif(a), inverse=True) == a.
    """
    dt = _work_dtype(field.p)
    a = np.asarray(a).astype(dt).copy()
    n = len(a)
    p = field.p
    if scale is None:
        scale = inverse
    stages_tw = tw.dit_stage_twiddles(field, n, inverse=inverse)
    for s in range(n.bit_length() - 1):
        t = 1 << s
        x = a.reshape(-1, 2, t)
        u = x[:, 0, :].copy()
        v = x[:, 1, :].copy()
        wvv = v * stages_tw[s].astype(dt).reshape(1, t) % p
        x[:, 0, :] = (u + wvv) % p
        x[:, 1, :] = (u - wvv) % p
        a = x.reshape(n)
    if scale:
        a = a * field.inv(n) % p
    return a


def ntt_forward(a, field: PrimeField) -> np.ndarray:
    """Natural in -> natural out forward NTT (DIF + bit-reversal)."""
    br = tw.bit_reverse_indices(len(a))
    return ntt_dif(a, field)[br]


def ntt_inverse(a, field: PrimeField) -> np.ndarray:
    """Natural in -> natural out inverse NTT (bit-reverse + DIT + 1/n)."""
    br = tw.bit_reverse_indices(len(a))
    return ntt_dit(np.asarray(a)[br], field, inverse=True)


def cyclic_polymul(a, b, field: PrimeField) -> np.ndarray:
    """c = a * b mod (X^n - 1): NTT -> pointwise -> INTT, bitrev-free."""
    fa = ntt_dif(a, field)
    fb = ntt_dif(b, field)
    return ntt_dit(fa * fb % field.p, field, inverse=True)


def negacyclic_polymul(a, b, field: PrimeField) -> np.ndarray:
    """c = a * b mod (X^n + 1): psi-scaled NTT (RLWE-style)."""
    p = field.p
    n = len(a)
    dt = _work_dtype(p)
    psi = tw.negacyclic_psi_powers(field, n).astype(dt)
    psi_inv = tw.negacyclic_psi_powers(field, n, inverse=True).astype(dt)
    ta = np.asarray(a).astype(dt) * psi % p
    tb = np.asarray(b).astype(dt) * psi % p
    tc = cyclic_polymul(ta, tb, field)
    return tc * psi_inv % p


def schoolbook_negacyclic(a, b, p: int) -> np.ndarray:
    """O(n^2) negacyclic convolution ground truth."""
    n = len(a)
    out = np.zeros(n, dtype=object)
    for i in range(n):
        ai = int(a[i])
        for j in range(n):
            k = i + j
            term = ai * int(b[j])
            if k < n:
                out[k] = (out[k] + term) % p
            else:
                out[k - n] = (out[k - n] - term) % p
    return out % p
