"""Prime fields and reduction constants for NTTs.

A copy of ``ntt_aie_tpu.fields`` (the port cannot import the reference
package: its ``__init__`` imports jax).
``tests/test_torch_tables.py`` pins every constant to the reference.

This is the L0 "math core" of the framework (SURVEY.md §7): prime/field
configuration, primitive roots, and the precomputed constants used by the
three modular-multiplication strategies of the column-pass kernels:

- ``barrett`` — the reference's "2k" Barrett variant (reference
  src/aie_core.cc:27-39 scalar, :64-102 vectorized; constants computed at
  graph-build time in reference src/aie2.py:18-19). Valid for p < 2^14 so
  every intermediate product fits in 32 bits.
- ``montgomery`` — REDC with R = 2^32 for word-size primes p < 2^31,
  using a 16-bit-limb ``umulhi32`` (TPU int32 lanes have no 64-bit
  accumulator analog of the reference's acc64, src/aie_core.cc:68-73).
- ``goldilocks`` — the 64-bit prime p = 2^64 - 2^32 + 1 on two uint32
  limbs with its special reduction identity 2^96 ≡ -1, 2^64 ≡ 2^32 - 1.

All functions here are pure-Python / host-side; tensor counterparts
live in ``ntt_aie_tpu_torch.ops.modops``.
"""

from __future__ import annotations

import dataclasses
import functools


def modpow(base: int, exp: int, mod: int) -> int:
    """x^n mod p. (Reference has a recursive int32 modPow, src/test.cpp:15-25,
    which overflows for large p; we use Python bignum pow.)"""
    return pow(base, exp, mod)


def _factorize(n: int) -> list[int]:
    """Distinct prime factors of n (trial division; n here is p-1 of a
    crypto-sized prime with smooth-enough cofactor, so this is fine for the
    primes we ship; user-supplied primes go through the same path)."""
    factors = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            factors.append(d)
            while n % d == 0:
                n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        factors.append(n)
    return factors


def primitive_root(p: int) -> int:
    """Smallest primitive root g of the prime p."""
    if p == 2:
        return 1
    factors = _factorize(p - 1)
    for g in range(2, p):
        if all(modpow(g, (p - 1) // q, p) != 1 for q in factors):
            return g
    raise ValueError(f"no primitive root found for {p} (not prime?)")


def max_ntt_size(p: int) -> int:
    """Largest power-of-two n with n | (p-1): the max radix-2 NTT length."""
    t = p - 1
    n = 1
    while t % 2 == 0:
        t //= 2
        n *= 2
    return n


def bit_length(p: int) -> int:
    return p.bit_length()


@dataclasses.dataclass(frozen=True)
class PrimeField:
    """An NTT-friendly prime field with precomputed reduction constants.

    Attributes:
      p: the prime modulus.
      g: a primitive root of p (generator of the multiplicative group).
      name: human-readable tag.
    """

    p: int
    g: int
    name: str = ""

    def __post_init__(self):
        if self.p < 3:
            raise ValueError("p must be an odd prime")
        if self.g % self.p == 0:
            raise ValueError(f"g={self.g} is not a unit mod {self.p}")
        # Primitivity: g^((p-1)/q) != 1 for every prime factor q of p-1.
        # (Fermat's g^(p-1) == 1 holds for EVERY unit, so checking only it
        # would accept non-primitive generators and silently break every
        # root_of_unity-derived table.) Trial division is capped so exotic
        # user primes still construct fast; a possibly-composite leftover
        # cofactor t is used as-is — that only makes the check more
        # permissive, never falsely rejects a true primitive root
        # (ord(g) = p-1 > (p-1)/t).
        t = self.p - 1
        factors = []
        d = 2
        while d * d <= t and d < (1 << 20):
            if t % d == 0:
                factors.append(d)
                while t % d == 0:
                    t //= d
            d += 1 if d == 2 else 2
        if t > 1:
            factors.append(t)
        for q in factors:
            if modpow(self.g, (self.p - 1) // q, self.p) == 1:
                raise ValueError(
                    f"g={self.g} is not a primitive root mod {self.p}: "
                    f"g^((p-1)/{q}) == 1"
                )

    # ---- generic ----

    @property
    def bits(self) -> int:
        return self.p.bit_length()

    @property
    def max_n(self) -> int:
        return max_ntt_size(self.p)

    def root_of_unity(self, n: int) -> int:
        """Primitive n-th root of unity omega = g^((p-1)/n) mod p
        (reference make_roots, src/test.cpp:27-32)."""
        if (self.p - 1) % n != 0:
            raise ValueError(f"n={n} does not divide p-1 for p={self.p}")
        return modpow(self.g, (self.p - 1) // n, self.p)

    def inv(self, x: int) -> int:
        return modpow(x, self.p - 2, self.p)

    # ---- Barrett "2k" variant (small primes, p < 2^14) ----
    # t = a*b; x1 = t >> (w-2); s = (u*x1) >> (w+2); c = t - s*p;
    # if c >= p: c -= p.  (reference src/aie_core.cc:27-39)

    @property
    def barrett_w(self) -> int:
        return self.p.bit_length()

    @property
    def barrett_u(self) -> int:
        w = self.barrett_w
        return (1 << (2 * w)) // self.p

    @property
    def supports_barrett32(self) -> bool:
        """True when all Barrett intermediates fit in 32 bits:
        u*x1 < 2^(2w+3) needs w <= 14."""
        return self.barrett_w <= 14

    # ---- Montgomery, R = 2^32 (word primes, p < 2^31) ----

    @property
    def mont_r(self) -> int:
        return 1 << 32

    @functools.cached_property
    def mont_neg_pinv(self) -> int:
        """(-p)^-1 mod 2^32, the REDC constant."""
        return (-pow(self.p, -1, self.mont_r)) % self.mont_r

    @functools.cached_property
    def mont_r_mod_p(self) -> int:
        return self.mont_r % self.p

    @functools.cached_property
    def mont_r2_mod_p(self) -> int:
        return (self.mont_r * self.mont_r) % self.p

    def to_mont(self, x: int) -> int:
        return (x * self.mont_r) % self.p

    @property
    def supports_mont32(self) -> bool:
        return self.p < (1 << 31) and self.p % 2 == 1

    @property
    def is_goldilocks(self) -> bool:
        return self.p == (1 << 64) - (1 << 32) + 1

    def default_reduction(self) -> str:
        if self.supports_barrett32:
            return "barrett"
        if self.p < (1 << 30) and self.p % 2 == 1:
            return "harvey"  # fewest multiplies (reductions.resolve_kind)
        if self.supports_mont32:
            return "montgomery"
        if self.is_goldilocks:
            return "goldilocks"
        raise ValueError(
            f"p={self.p}: no TPU reduction strategy (need p<2^31 or Goldilocks)"
        )


# ---- shipped fields ----

#: Kyber prime — the reference's only field (p=3329, g=3; reference
#: src/test.cpp:76-77, src/aie2.py:16-19). max NTT size 256... note
#: (p-1) = 2^8 * 13, so true NTT max n = 256; the reference runs its
#: *table-parameterized butterfly network* at n=2048, which is well-defined
#: for any table even when no 2048th root exists (SURVEY.md §0).
KYBER = PrimeField(p=3329, g=3, name="kyber")

#: Dilithium prime, p = 2^23 - 2^13 + 1, max n = 2^13.
DILITHIUM = PrimeField(p=8380417, g=10, name="dilithium")

#: 998244353 = 119 * 2^23 + 1, the competitive-programming classic, max n = 2^23.
P_998244353 = PrimeField(p=998244353, g=3, name="p998244353")

#: 2013265921 = 15 * 2^27 + 1 (< 2^31), max n = 2^27 — the workhorse
#: word-size prime for n up to 2^24 and beyond.
P_2013265921 = PrimeField(p=2013265921, g=31, name="p2013265921")

#: 469762049 = 7 * 2^26 + 1 (< 2^29), max n = 2^26 — the Harvey-eligible
#: (p < 2^30) prime for the lazy-butterfly fast path at n up to 2^24.
P_469762049 = PrimeField(p=469762049, g=3, name="p469762049")

#: Goldilocks, p = 2^64 - 2^32 + 1, g = 7, max n = 2^32. The 64-bit-prime
#: target (BASELINE.json config 4) via 32-bit limb decomposition.
GOLDILOCKS = PrimeField(p=(1 << 64) - (1 << 32) + 1, g=7, name="goldilocks")

FIELDS = {
    f.name: f
    for f in [KYBER, DILITHIUM, P_998244353, P_2013265921, P_469762049, GOLDILOCKS]
}
