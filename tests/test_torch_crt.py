"""The CRT combine (plain PyTorch version, CPU) and limbs_to_int against
the JAX package's ``ops.crt`` (make_crt_combine, limbs_to_int), bit for
bit, for k = 1 to 4 residue primes (the default RNS primes, and the
largest primes below 2^31, whose M = prod(p) comes nearest 2^(32 nwords)),
centered and not, on random residues and on the residues of edge values
(0, 1, M/2, M/2 + 1, M - 1), which must come back as those integers.
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu import fields as jF
from ntt_aie_tpu.ops import crt as jcrt

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch.fields import primitive_root
from ntt_aie_tpu_torch.ops import crt

# the default RNS primes, and the largest four primes below 2^31
PRIME_SETS = [(469762049,), (998244353, 469762049),
              (2013265921, 998244353, 469762049),
              (2147483647, 2147483629),
              (2147483647, 2147483629, 2147483587, 2147483579)]


def _fields(primes):
    return ([T.PrimeField(p, primitive_root(p)) for p in primes],
            [jF.PrimeField(p, jF.primitive_root(p)) for p in primes])


def _edge_values(modulus):
    return [0, 1, modulus >> 1, (modulus >> 1) + 1, modulus - 1]


@pytest.mark.parametrize("centered", [True, False])
@pytest.mark.parametrize("primes", PRIME_SETS)
def test_combine_matches_reference(primes, centered):
    tf, jf = _fields(primes)
    fn, nwords = crt.make_crt_combine(tf, centered=centered, device="cpu")
    jfn, jnwords = jcrt.make_crt_combine(jf, centered=centered)
    modulus = math.prod(primes)
    assert nwords == jnwords == -(-modulus.bit_length() // 32)
    rng = np.random.default_rng(len(primes))
    xs = _edge_values(modulus) + [int(v) * modulus >> 64 for v in
                                  rng.integers(0, 1 << 63, 59,
                                               dtype=np.uint64)]
    res = [np.array([x % p for x in xs], dtype=np.uint32).reshape(8, 8)
           for p in primes]
    got = fn(*res)
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, 8, nwords)
    got = got.numpy().view(np.uint32)
    want = np.asarray(jfn(*(jnp.asarray(r) for r in res)))
    assert np.array_equal(got, want)
    values = crt.limbs_to_int(got, signed=centered).reshape(-1)
    half = modulus >> 1
    for x, v in zip(xs, values):
        assert v == (x - modulus if centered and x > half else x)
    assert np.array_equal(values, jcrt.limbs_to_int(want, signed=centered)
                          .reshape(-1))


def test_combine_takes_tensors_in_field_order():
    """The residues come in the order of `fields`; the chain sorts them."""
    tf, _ = _fields((469762049, 2013265921, 998244353))
    fn, _ = crt.make_crt_combine(tf, device="cpu")
    x = 123456789012345678901234567
    res = [torch.tensor([x % f.p, (-x) % f.p]).to(torch.int32) for f in tf]
    assert list(crt.limbs_to_int(fn(*res))) == [x, -x]
    assert crt.crt_combine.launches == 0


@pytest.mark.parametrize("signed", [True, False])
def test_limbs_to_int_matches_reference(signed):
    rng = np.random.default_rng(5)
    for L in range(0, 6):
        limbs = rng.integers(0, 1 << 32, (3, 4, L), dtype=np.uint64)
        limbs = limbs.astype(np.uint32)
        got = crt.limbs_to_int(limbs, signed=signed)
        want = jcrt.limbs_to_int(limbs, signed=signed)
        assert got.shape == want.shape == (3, 4)
        assert np.array_equal(got, want)
        tensor = torch.from_numpy(limbs.view(np.int32))
        assert np.array_equal(crt.limbs_to_int(tensor, signed=signed), want)


def test_combine_rejects_what_the_reference_rejects():
    tf, jf = _fields((469762049, 998244353))
    cases = [([], []), ([tf[0], tf[0]], [jf[0], jf[0]]),
             ([T.GOLDILOCKS], [jF.GOLDILOCKS])]
    for tfs, jfs in cases:
        with pytest.raises(ValueError) as terr:
            crt.make_crt_combine(tfs, device="cpu")
        with pytest.raises(ValueError) as jerr:
            jcrt.make_crt_combine(jfs)
        assert str(terr.value) == str(jerr.value)
    fn, _ = crt.make_crt_combine(tf, device="cpu")
    with pytest.raises(ValueError, match="expected 2 residue arrays"):
        fn(np.zeros(4, np.uint32))
    with pytest.raises(ValueError, match="one shape"):
        fn(np.zeros(4, np.uint32), np.zeros(5, np.uint32))
    many = [T.PrimeField(p, primitive_root(p))
            for p in (3, 5, 7, 11, 13, 17, 19, 23, 29)]
    with pytest.raises(ValueError, match="at most 8 primes"):
        crt.make_crt_combine(many, device="cpu")
