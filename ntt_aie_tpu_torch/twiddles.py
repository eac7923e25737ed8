"""Twiddle-factor planning for the four-step column passes.

A NumPy copy of the parts of ``ntt_aie_tpu.twiddles`` that the four-step
fold, factored and fused plans and the flat stage loops need (the port
cannot import the reference package: its ``__init__`` imports jax). The
spectral order is still defined once: ``col_network``/
``spectral_positions`` here are line-for-line copies, and
``tests/test_torch_tables.py`` pins every table to the reference with
``np.array_equal``. Every column transform of the port — the CUDA kernel
and its plain PyTorch version — compiles from ``col_network``; never
hand-build stage twiddles for a four-step column.

Values are int64 NumPy arrays for 32-bit word primes and uint64 arrays
for Goldilocks (p = 2^64 - 2^32 + 1), as in the reference; other primes
of 31 bits or more are refused.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ntt_aie_tpu_torch.fields import PrimeField


_GL_P = np.uint64((1 << 64) - (1 << 32) + 1)


def _tw_dtype(field: PrimeField):
    """Value-array dtype: int64 for word primes, uint64 for Goldilocks
    (every value is exact in uint64; only the arithmetic needs wider
    math, which _gl_mulmod_vec supplies)."""
    if field.p < (1 << 31):
        return np.int64
    if field.p == int(_GL_P):
        return np.uint64
    raise NotImplementedError(
        f"p={field.p}: the port plans 32-bit word primes and Goldilocks "
        "only (the reference's object-dtype tables for other primes feed "
        "no plan)")


# _gl_mulmod_vec's block: its two dozen temporaries of this many values
# stay in cache (a whole 2^27-value table's each took a fresh GiB)
_GL_BLOCK = 1 << 14


def _gl_mulmod_vec(a, b) -> np.ndarray:
    """Elementwise a*b mod p for Goldilocks on uint64 arrays: 4 x 32-bit
    partial products assembled into a 128-bit (hi, lo) pair with explicit
    carries, then reduced with 2^64 = 2^32 - 1, 2^96 = -1 (the algorithm
    of native/oracle.cc ntt_goldilocks_reduce128). Runs in blocks of
    _GL_BLOCK values."""
    a, b = np.broadcast_arrays(np.asarray(a, dtype=np.uint64),
                               np.asarray(b, dtype=np.uint64))
    if a.size <= _GL_BLOCK:
        return _gl_mulmod_block(a, b)
    out = np.empty(a.shape, dtype=np.uint64)
    fa, fb, fo = a.reshape(-1), b.reshape(-1), out.reshape(-1)
    for i in range(0, a.size, _GL_BLOCK):
        fo[i:i + _GL_BLOCK] = _gl_mulmod_block(fa[i:i + _GL_BLOCK],
                                               fb[i:i + _GL_BLOCK])
    return out


def _gl_mulmod_block(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """_gl_mulmod_vec on one block of uint64 arrays of one shape."""
    mask = np.uint64(0xFFFFFFFF)
    s32 = np.uint64(32)
    ah, al = a >> s32, a & mask
    bh, bl = b >> s32, b & mask
    ll = al * bl
    hh = ah * bh
    hl = ah * bl
    mid = hl + al * bh                       # wraps; carry below
    mid_carry = (mid < hl).astype(np.uint64)  # in units of 2^96
    lo = ll + (mid << s32)                   # wraps; carry below
    lo_carry = (lo < ll).astype(np.uint64)
    hi = hh + (mid >> s32) + (mid_carry << s32) + lo_carry
    # x = lo + n2*(2^32 - 1) - n3 (mod p)
    n3 = hi >> s32
    n2_ = hi & mask
    r = np.where(lo >= _GL_P, lo - _GL_P, lo)
    r = np.where(r < n3, r + _GL_P, r) - n3
    t1 = (n2_ << s32) - n2_
    s = r + t1
    s = np.where(s < r, s + mask, s)  # 2^64 wrap adds 2^32 - 1 back
    return np.where(s >= _GL_P, s - _GL_P, s)


def _vec_mulmod(field: PrimeField):
    """Elementwise host mulmod on this field's value arrays: plain uint64
    products for word primes (exact: p < 2^31), the limb algorithm above
    for Goldilocks."""
    if _tw_dtype(field) is np.uint64:
        return _gl_mulmod_vec
    pu = np.uint64(field.p)

    def mul(a, b):
        return np.asarray(a, np.uint64) * np.asarray(b, np.uint64) % pu

    return mul


def _power_series(field: PrimeField, w: int, n: int) -> np.ndarray:
    """[w^i mod p for i in range(n)] in the field's value dtype, by
    log-depth block doubling (out[m:2m] = out[:m] * w^m)."""
    dt = _tw_dtype(field)
    mul = _vec_mulmod(field)
    p = field.p
    out = np.empty(n, dtype=np.uint64)
    out[0] = 1
    cur = w % p  # w^m for the current block width m
    m = 1
    while m < n:
        step = min(m, n - m)
        out[m:m + step] = mul(out[:step], cur)
        m *= 2
        if m < n:
            cur = cur * cur % p
    return out.astype(dt)


def root_powers(field: PrimeField, n: int) -> np.ndarray:
    """w^i for i in [0, n), w = field.root_of_unity(n)."""
    return _power_series(field, field.root_of_unity(n), n)


def negacyclic_psi_powers(field: PrimeField, n: int, *,
                          inverse: bool = False) -> np.ndarray:
    """psi^i for i in [0, n) where psi is a primitive 2n-th root (psi^2 =
    omega): the pre/post scalings of the negacyclic product (X^n + 1)."""
    psi = field.root_of_unity(2 * n)
    if inverse:
        psi = field.inv(psi)
    return _power_series(field, psi, n)


def power_table(field: PrimeField, n: int, *,
                inverse: bool = False) -> np.ndarray:
    """Natural-order table t[i] = w^i with w = g^((p-1)//n): the
    reference device's make_roots (its src/test.cpp:27-32), integer
    division included. At its committed configuration (p = 3329,
    n = 2048) n does not divide p - 1, so w = g = 3 is not a 2048th root
    of unity; the parity mode reproduces exactly that network. Use
    root_powers / dif_stage_twiddles for true NTTs."""
    w = pow(field.g, (field.p - 1) // n, field.p)
    if inverse:
        w = field.inv(w)
    return _power_series(field, w, n)


def bit_reverse_indices(n: int) -> np.ndarray:
    """Bit-reversal permutation of [0, n)."""
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for _ in range(bits):
        rev = (rev << 1) | (idx & 1)
        idx >>= 1
    return rev


def dif_stage_twiddles(field: PrimeField, n: int, *,
                       inverse: bool = False) -> list[np.ndarray]:
    """Gentleman-Sande DIF twiddles, natural in -> bit-reversed out.

    Stage s works at half-block size t = n >> (s+1); butterfly
    (u+v, (u-v)*w[jj]) with w[jj] = omega^(jj * 2^s), jj in [0, t).
    """
    logn = n.bit_length() - 1
    w = field.root_of_unity(n)
    if inverse:
        w = field.inv(w)
    return [_power_series(field, pow(w, 1 << s, field.p), n >> (s + 1))
            for s in range(logn)]


def dit_stage_twiddles(field: PrimeField, n: int, *,
                       inverse: bool = False) -> list[np.ndarray]:
    """Cooley-Tukey DIT twiddles, bit-reversed in -> natural out.

    Stage s works at half-block size t = 2^s; butterfly
    (u + w[jj]*v, u - w[jj]*v) with w[jj] = omega^(jj * n/(2t)).
    """
    logn = n.bit_length() - 1
    w = field.root_of_unity(n)
    if inverse:
        w = field.inv(w)
    return [_power_series(field, pow(w, n >> (s + 1), field.p), 1 << s)
            for s in range(logn)]


def pack_stage_twiddles(stages: list[np.ndarray], n: int) -> np.ndarray:
    """Pack per-stage vectors into one (log2 n, n//2) matrix, each stage's
    vector tiled to length n//2 (DIF stage s has n >> (s+1) values, DIT
    stage s has 2^s): the flat stage loops' table layout
    (``ops.stages``)."""
    half = n // 2
    logn = n.bit_length() - 1
    out = np.zeros((logn, half), dtype=stages[0].dtype)
    for s, vec in enumerate(stages):
        out[s] = np.tile(vec, half // len(vec))
    return out


def nested_col_split(nn: int) -> int:
    """R for the nested R x S column decomposition (0 = plain DIF/DIT).
    Columns of 256 rows or more nest, with R = 2^floor(log2(nn)/2)."""
    if nn < 256:
        return 0
    return 1 << ((nn.bit_length() - 1) // 2)


def colperm(nn: int) -> np.ndarray:
    """Output row order sigma of one length-nn column transform: out row
    j holds X[sigma(j)]. Plain: bit reversal. Nested R x S: the composed
    order sigma(s*R + r) = brS(s)*R + brR(r). Both are involutions."""
    R = nested_col_split(nn)
    if not R:
        return bit_reverse_indices(nn)
    S = nn // R
    brR = bit_reverse_indices(R)
    brS = bit_reverse_indices(S)
    return (brS[:, None] * np.int64(R) + brR[None, :]).ravel()


def spectral_positions(n1: int, n2: int) -> np.ndarray:
    """pos such that natural[k] = flat[pos[k]] for the four-step flat
    spectral output flat[c*n1 + r] = X[s2(c)*n1 + s1(r)] (s1/s2 =
    colperm). Flat path (n2 == 1): plain bit reversal. pos is an
    involution, so it converts in both directions."""
    if n2 == 1:
        return bit_reverse_indices(n1).astype(np.int32)
    s1 = colperm(n1)
    s2 = colperm(n2)
    return (s2[:, None].astype(np.int32) * np.int32(n1)
            + s1[None, :].astype(np.int32)).ravel()


def flat_gather(n1: int, n2: int) -> np.ndarray:
    """g such that the flat (bit-reversed) spectrum of n = n1 * n2 points
    is the (n1, n2) four-step spectrum's flat output at g: flat[j] =
    fourstep[g[j]], g = spectral_positions(n1, n2)[bit_reverse_indices(n)].
    Its inverse permutation is bit_reverse_indices(n)[spectral_positions(
    n1, n2)] (both are involutions). int64, for torch's index_select."""
    n = n1 * n2
    return spectral_positions(n1, n2).astype(np.int64)[bit_reverse_indices(n)]


def col_network(field: PrimeField, nn: int, *, direction: str,
                inverse: bool = False) -> dict:
    """The complete stage schedule of one length-nn column transform.

    Plain (nested_col_split(nn) == 0): one phase of standard DIF/DIT
    stages; mid is None.

    Nested R x S: two phases whose stage twiddles are expanded with
    np.repeat so the passthrough axis rides inside each stage (repeat by S
    in the R-phase, by R in the S-phase); a stage of half size t pairs rows
    (b*2t + j, b*2t + t + j) and multiplies by vec[j]. Between the phases:
      DIF:  x *= wmid (rows r*S+s hold w_nn^(+-brR(r)*s)); then the row
            at r*S + s moves to s*R + r;
      DIT:  the mirror — the inverse move first, then the multiply.

    Returns {"phases": [{"ts": [int, ...], "vecs": [np.ndarray, ...]}],
             "mid": None | {"wmid": (nn,) values, "kind": direction},
             "R": R, "S": S}.
    """
    R = nested_col_split(nn)
    if not R:
        gen = dif_stage_twiddles if direction == "dif" else dit_stage_twiddles
        vecs = gen(field, nn, inverse=inverse)
        logn = nn.bit_length() - 1
        ts = ([nn >> (s + 1) for s in range(logn)] if direction == "dif"
              else [1 << s for s in range(logn)])
        return {"phases": [{"ts": ts, "vecs": vecs}], "mid": None,
                "R": 0, "S": 0}
    S = nn // R
    logR, logS = R.bit_length() - 1, S.bit_length() - 1
    w_nn = field.root_of_unity(nn)
    pows = _power_series(field, field.inv(w_nn) if inverse else w_nn, nn)
    e = (bit_reverse_indices(R)[:, None] * np.arange(S)[None, :]) & (nn - 1)
    wmid = pows[e].ravel()
    if direction == "dif":
        phases = [
            {"ts": [(R >> (s + 1)) * S for s in range(logR)],
             "vecs": [np.repeat(v, S) for v in
                      dif_stage_twiddles(field, R, inverse=inverse)]},
            {"ts": [(S >> (s + 1)) * R for s in range(logS)],
             "vecs": [np.repeat(v, R) for v in
                      dif_stage_twiddles(field, S, inverse=inverse)]},
        ]
    else:
        phases = [
            {"ts": [(1 << s) * R for s in range(logS)],
             "vecs": [np.repeat(v, R) for v in
                      dit_stage_twiddles(field, S, inverse=inverse)]},
            {"ts": [(1 << s) * S for s in range(logR)],
             "vecs": [np.repeat(v, S) for v in
                      dit_stage_twiddles(field, R, inverse=inverse)]},
        ]
    return {"phases": phases, "mid": {"wmid": wmid, "kind": direction},
            "R": R, "S": S}


def _build_fourstep_tables(field: PrimeField, n1: int, n2: int) -> dict:
    n = n1 * n2
    n_inv = field.inv(n)
    # One shared power table; the pass-1 output row order (colperm) is
    # folded into the exponent rows, and the inverse matrix reuses the
    # same exponents at (n - e).
    pows = root_powers(field, n)
    k1r = colperm(n1).astype(np.int64)
    j2 = np.arange(n2, dtype=np.int64)
    e = (k1r[:, None] * j2[None, :]) & (n - 1)
    wmat = pows[e]
    iwmat_scaled = _vec_mulmod(field)(pows[(n - e) & (n - 1)],
                                      n_inv).astype(_tw_dtype(field))
    return {
        "wmat": wmat,
        "iwmat_scaled": iwmat_scaled,
        "pos": spectral_positions(n1, n2),
        "n_inv": n_inv,
    }


# In-process memo, as in the reference: repeated plan builds in one
# process pay the O(n) table build once per (p, g, n1, n2). Cached arrays
# are read-only so an accidental in-place write raises. The reference's
# opt-in disk cache is not ported yet.
_FOURSTEP_MEMO: OrderedDict = OrderedDict()
_FOURSTEP_MEMO_MAX = 8


def fourstep_tables(field: PrimeField, n1: int, n2: int) -> dict:
    """The four-step plan's host tables:

      wmat         — forward twiddle matrix W[s1(r), j2], (n1, n2) in the
                     field's value dtype (int64, or uint64 for Goldilocks),
      iwmat_scaled — inverse matrix likewise, additionally folding 1/n,
      pos          — spectral_positions(n1, n2),
      n_inv        — 1/n mod p.

    Memoized in-process; returned arrays are read-only.
    """
    key = (field.p, field.g, n1, n2)
    hit = _FOURSTEP_MEMO.get(key)
    if hit is not None:
        _FOURSTEP_MEMO.move_to_end(key)
        return hit
    tabs = _build_fourstep_tables(field, n1, n2)
    for v in tabs.values():
        if isinstance(v, np.ndarray):
            v.setflags(write=False)
    _FOURSTEP_MEMO[key] = tabs
    while len(_FOURSTEP_MEMO) > _FOURSTEP_MEMO_MAX:
        _FOURSTEP_MEMO.popitem(last=False)
    return tabs


def fourstep_tables_light(field: PrimeField, n1: int, n2: int) -> dict:
    """pos and n_inv only: the factored plans (wmat_factored=True) take the
    four-step multiply from fourstep_wfac_T's tables and never build the
    n1 x n2 matrices."""
    return {"pos": spectral_positions(n1, n2), "n_inv": field.inv(n1 * n2)}


def default_wfac_split(n2: int) -> int:
    """The factored four-step matrix's split S ~ sqrt(n2), which makes the
    table rows n2/S + S fewest."""
    return 1 << ((n2.bit_length() - 1) // 2)


def fourstep_wfac_T(field: PrimeField, n1: int, n2: int, *,
                    inverse: bool = False, scale: int | None = None,
                    split: int | None = None,
                    _pows: np.ndarray | None = None):
    """The four-step matrix in the transposed orientation, factored.

    wmat.T[c, r] = W^(+-br1(r) * c) [* scale] (rows c linear in the
    exponent, the pass-1 row order on r) is, over c = c1*S + c0, the
    entrywise product T1[c1, r] * T2[c0, r] mod p of

        T1[c1, r] = W^(+-br1(r) * S * c1)         shape (n2/S, n1)
        T2[c0, r] = W^(+-br1(r) * c0) [* scale]   shape (S, n1)

    so a column pass multiplies by T1 and then T2 against (n2/S + S) * n1
    entries instead of n1 * n2. `scale` (1/n for the inverse) folds into
    T2. _pows: root_powers(field, n), to build it once for several
    tables."""
    n = n1 * n2
    S = split or default_wfac_split(n2)
    if n2 % S != 0:
        raise ValueError(f"split {S} must divide n2={n2}")
    pows = root_powers(field, n) if _pows is None else _pows
    k1r = colperm(n1).astype(np.int64)
    sgn = -1 if inverse else 1
    c1 = (np.arange(n2 // S, dtype=np.int64) * S)[:, None]
    c0 = np.arange(S, dtype=np.int64)[:, None]
    t1 = pows[(sgn * k1r[None, :] * c1) % n]
    t2 = pows[(sgn * k1r[None, :] * c0) % n]
    if scale is not None:
        t2 = _vec_mulmod(field)(t2, scale).astype(_tw_dtype(field),
                                                  copy=False)
    return np.ascontiguousarray(t1), np.ascontiguousarray(t2)


def negacyclic_psi_factors(field: PrimeField, n1: int, n2: int, *,
                           inverse: bool = False):
    """The negacyclic psi matrix as a rank-1 product: the (n1, n2) reshape
    of psi^i is psi^(r*n2 + c) = (psi^n2)^r * psi^c, so it is
    row[r] * col[c] of two vectors of n1 and n2 entries. The psi of
    negacyclic_psi_powers."""
    n = n1 * n2
    psi = field.root_of_unity(2 * n)
    if inverse:
        psi = field.inv(psi)
    col = _power_series(field, psi, n2)
    row = _power_series(field, pow(psi, n2, field.p), n1)
    return row, col
