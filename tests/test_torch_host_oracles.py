"""The port's host oracles that have no kernel behind them, held against
the JAX package's: the O(n^2) DFT and schoolbook cyclic product
(``reference.naive_dft``, ``reference.schoolbook_cyclic``) and the native
oracle's scalar modular multiplies (``native_oracle.barrett_mulmod``,
``mont_mulmod``, ``goldilocks_mulmod``, ``goldilocks_reduce128``, one
``native/libnttoracle.so`` behind both packages). Exact integers: the
comparison is raw."""

import numpy as np
import pytest

from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import native_oracle as jnative
from ntt_aie_tpu import reference as jref

from ntt_aie_tpu_torch import fields as tF
from ntt_aie_tpu_torch import native_oracle as tnative
from ntt_aie_tpu_torch import reference as tref

DFT_FIELDS = ["p469762049", "p2013265921", "kyber", "goldilocks"]


def _draw(p, n, seed):
    rng = np.random.default_rng([seed, n, p % (1 << 32)])
    return np.array([int(v) % p for v in rng.integers(0, 1 << 62, n)],
                    dtype=object)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("name", DFT_FIELDS)
def test_naive_dft_matches_reference(name, inverse):
    """naive_dft forward and inverse against the JAX package's, and the
    inverse undoing the forward."""
    tf, jf = tF.FIELDS[name], jF.FIELDS[name]
    n = 16
    a = _draw(tf.p, n, 1)
    got = tref.naive_dft(a, tf, inverse=inverse)
    assert got.dtype == object
    assert np.array_equal(got, jref.naive_dft(a, jf, inverse=inverse))
    if not inverse:
        assert np.array_equal(tref.naive_dft(got, tf, inverse=True), a)


@pytest.mark.parametrize("name", DFT_FIELDS)
def test_schoolbook_cyclic_matches_reference(name):
    """schoolbook_cyclic against the JAX package's and, where the field
    has the root, the port's NTT cyclic product."""
    tf = tF.FIELDS[name]
    n = 16
    a, b = _draw(tf.p, n, 2), _draw(tf.p, n, 3)
    got = tref.schoolbook_cyclic(a, b, tf.p)
    assert np.array_equal(got, jref.schoolbook_cyclic(a, b, tf.p))
    assert np.array_equal(got, np.asarray(tref.cyclic_polymul(a, b, tf))
                          .astype(object) % tf.p)


def _edges(p):
    return sorted({0, 1, 2, p // 2, p - 2, p - 1})


@pytest.mark.parametrize("name", ["kyber", "p469762049", "p2013265921"])
def test_scalar_mulmods_match_reference(name):
    """barrett_mulmod (where the field has Barrett constants) and
    mont_mulmod at the edges and at random pairs, against the JAX
    package's bindings and exact arithmetic."""
    f = tF.FIELDS[name]
    p = f.p
    rng = np.random.default_rng(p)
    pairs = [(a, b) for a in _edges(p) for b in _edges(p)]
    pairs += [tuple(int(v) for v in rng.integers(0, p, 2)) for _ in range(64)]
    r_inv = pow(1 << 32, -1, p)
    for a, b in pairs:
        got = tnative.mont_mulmod(a, b, p, f.mont_neg_pinv)
        assert got == jnative.mont_mulmod(a, b, p, f.mont_neg_pinv)
        assert got % p == a * b * r_inv % p
        if name == "kyber":
            w, u = f.barrett_w, f.barrett_u
            got = tnative.barrett_mulmod(a, b, p, w, u)
            assert got == jnative.barrett_mulmod(a, b, p, w, u)
            assert got == a * b % p


def test_goldilocks_scalars_match_reference():
    """goldilocks_mulmod and goldilocks_reduce128 at the edges and at
    random values, against the JAX package's bindings and exact
    arithmetic."""
    p = tF.GOLDILOCKS.p
    eps = (1 << 32) - 1
    vals = [0, 1, 2, eps, 1 << 32, p - (1 << 32), p - 2, p - 1, 1 << 63]
    rng = np.random.default_rng(7)
    vals += [int(v) % p for v in rng.integers(0, 1 << 63, 16)]
    for a in vals:
        for b in vals[:8]:
            got = tnative.goldilocks_mulmod(a, b)
            assert got == jnative.goldilocks_mulmod(a, b) == a * b % p
    wide = [0, p, (1 << 128) - 1, (p - 1) * (p - 1), 1 << 96, (1 << 64) - 1]
    wide += [int(a) << 64 | int(b) for a, b in rng.integers(0, 1 << 63, (16, 2))]
    for x in wide:
        got = tnative.goldilocks_reduce128(x)
        assert got == jnative.goldilocks_reduce128(x)
        assert got % p == x % p
