"""NumPy golden oracles: the reference device's butterfly network, the
O(n^2) DFT, textbook DIF/DIT NTTs, the cyclic and negacyclic products, and
the O(n^2) schoolbook cyclic and negacyclic products.

A copy of ``ntt_aie_tpu.reference``: int64 NumPy for 32-bit word primes,
Python integers (object arrays) for Goldilocks. It shares no arithmetic
with the column-pass kernels or their plain versions (Python's ``%`` on
exact integers), so it can judge both; ``chip_smoke.py`` falls back to it
when the native C++ oracle cannot be built.

The reference-parity half is the reference device's CPU oracle (its
src/test.cpp:34-60): Gentleman-Sande butterflies with increasing stride
t = 1, 2, ..., n/2 against a caller's table indexed ``table[h+i]`` at each
stage, and the 16-block output placement ``ANS_ORDER_16`` of its swap
network. With the natural-order power table (``twiddles.power_table``) it
is not a DFT; parity is defined against the network with that table.
"""

from __future__ import annotations

import numpy as np

from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.fields import PrimeField, modpow


def _work_dtype(p: int):
    return object if p >= (1 << 31) else np.int64


# The fixed output block order of the reference device's 16-tile swap
# network (its src/test.cpp:69-71): device block i lands at position
# ANS_ORDER_16[i] of the oracle's block order.
ANS_ORDER_16 = np.array([0, 2, 1, 3, 8, 10, 9, 11, 4, 6, 5, 7, 12, 14, 13, 15])


def reference_network(a, table, p: int,
                      stages: int | None = None) -> np.ndarray:
    """The reference oracle's butterfly network, vectorized.

    Stage s (s = 0, 1, ...): m = n >> s, h = m/2 groups, stride t = 2^s;
    group i pairs elements (2t*i + jj, 2t*i + jj + t) for jj in [0, t) and
    applies the GS butterfly (u+v, (u-v)*table[h+i]) mod p. Any length-n
    table is legal. stages: run only stages 0..stages inclusive (the
    reference's partial-depth hook); None is full depth."""
    dt = _work_dtype(p)
    a = np.asarray(a).astype(dt).copy()
    table = np.asarray(table).astype(dt)
    n = len(a)
    t, idx, m = 1, 0, n
    while m > 1:
        h = m // 2
        x = a.reshape(h, 2, t)
        u = x[:, 0, :].copy()
        v = x[:, 1, :].copy()
        roots = table[h: h + h].reshape(h, 1)
        x[:, 0, :] = (u + v) % p
        x[:, 1, :] = ((u - v) % p) * roots % p
        a = x.reshape(n)
        if stages is not None and idx == stages:
            return a
        t <<= 1
        m >>= 1
        idx += 1
    return a


def reference_network_scalar(a, table, p: int, stage: int) -> np.ndarray:
    """Scalar transcription of the reference oracle's loops, an
    independent cross-check of reference_network (small n only)."""
    a = [int(v) for v in a]
    table = [int(v) for v in table]
    n = len(a)
    t, idx, m = 1, 0, n
    while m > 1:
        j1, h = 0, m // 2
        for i in range(h):
            j2 = j1 + t - 1
            for j in range(j1, j2 + 1):
                root = table[h + i]
                v0, v1 = a[j], a[j + t]
                a[j] = (v0 + v1) % p
                a[j + t] = ((v0 + p - v1) % p) * root % p
            j1 += 2 * t
        if idx == stage:
            return np.array(a, dtype=object)
        t <<= 1
        m >>= 1
        idx += 1
    return np.array(a, dtype=object)


def block_permute(a: np.ndarray,
                  order: np.ndarray = ANS_ORDER_16) -> np.ndarray:
    """The reference device's output block placement: oracle block i is
    found at device position order[i]."""
    nb = len(order)
    bs = len(a) // nb
    out = np.empty_like(a)
    for i in range(nb):
        out[order[i] * bs: order[i] * bs + bs] = a[i * bs: i * bs + bs]
    return out


def reference_device_output(a, field: PrimeField, n: int) -> np.ndarray:
    """What the reference device produces for input a: the natural-order
    power table, the full-depth network, the block placement."""
    table = tw.power_table(field, n)
    return block_permute(reference_network(a, table, field.p))


def naive_dft(a, field: PrimeField, *, inverse: bool = False) -> np.ndarray:
    """O(n^2) ground truth in exact integers: A[k] = sum_j a[j] w^(jk) mod
    p, natural order in and out (the inverse with w^-1 and the 1/n
    scale)."""
    a = np.asarray(a)
    n = len(a)
    p = field.p
    w = field.root_of_unity(n)
    if inverse:
        w = field.inv(w)
    out = np.zeros(n, dtype=object)
    for k in range(n):
        acc, cur, wk = 0, 1, modpow(w, k, p)
        for j in range(n):
            acc = (acc + int(a[j]) * cur) % p
            cur = cur * wk % p
        out[k] = acc
    if inverse:
        out = out * field.inv(n) % p
    return out


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
    """O(n^2) negacyclic convolution ground truth, in exact (object)
    integers: a[i] * b lands on coefficients i..n-1 and, negated, wraps
    onto 0..i-1; reduced mod p once at the end."""
    n = len(a)
    a = np.array([int(v) for v in a], dtype=object)
    b = np.array([int(v) for v in b], dtype=object)
    out = np.zeros(n, dtype=object)
    for i in range(n):
        term = a[i] * b
        out[i:] += term[:n - i]
        out[:i] -= term[n - i:]
    return out % p


def schoolbook_cyclic(a, b, p: int) -> np.ndarray:
    """O(n^2) cyclic convolution ground truth in exact (object) integers:
    a[i] * b lands on coefficients (i + j) mod n; reduced mod p."""
    n = len(a)
    a = np.array([int(v) for v in a], dtype=object)
    b = np.array([int(v) for v in b], dtype=object)
    out = np.zeros(n, dtype=object)
    for i in range(n):
        out += a[i] * np.roll(b, i)
    return out % p
