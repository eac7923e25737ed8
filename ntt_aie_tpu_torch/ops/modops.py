"""Modular arithmetic on int64 tensors that carry uint32 values.

Twins of ``ntt_aie_tpu.ops.modops``. PyTorch's CPU uint32 has no ``+``,
``>>`` or ``<``, so every value here is an int64 tensor holding a uint32
bit pattern in [0, 2^32), and every result is masked back to 32 bits: the
results equal the reference's uint32 results bit for bit, wrap-around
included. A full 32x32 product does not fit int64, so high and low words
are assembled from 16-bit limbs as the reference does.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
MASK16 = 0xFFFF


def to_carrier(x: torch.Tensor) -> torch.Tensor:
    """int32 (or any integer) tensor -> int64 carrier of its uint32 bits."""
    return x.to(torch.int64) & MASK32


def from_carrier(x: torch.Tensor) -> torch.Tensor:
    """int64 carrier -> int32 tensor with the same 32-bit pattern."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def umulhi32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High 32 bits of the 64-bit product of two uint32 values."""
    al, ah = a & MASK16, a >> 16
    bl, bh = b & MASK16, b >> 16
    mid = al * bh + ((al * bl) >> 16)
    mid2 = ah * bl + (mid & MASK16)
    return (ah * bh + (mid >> 16) + (mid2 >> 16)) & MASK32


def mullo32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of the product of two uint32 values (uint32 `*`)."""
    al, ah = a & MASK16, a >> 16
    bl, bh = b & MASK16, b >> 16
    return (al * bl + (((ah * bl + al * bh) & MASK16) << 16)) & MASK32


def add_mod(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """(a + b) mod p for a, b in [0, p), p < 2^31."""
    s = (a + b) & MASK32
    return torch.where(s >= p, s - p, s)


def sub_mod(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """(a - b) mod p for a, b in [0, p)."""
    d = (a + ((p - b) & MASK32)) & MASK32
    return torch.where(d >= p, d - p, d)


def mont_redc(hi: torch.Tensor, lo: torch.Tensor, p: int,
              neg_pinv: int) -> torch.Tensor:
    """REDC with R = 2^32: given T = hi*2^32 + lo < p*2^32, return
    T * R^-1 mod p (the reference's carry trick: the low word of
    T + m*p is zero, so the division is hi + umulhi(m, p) + (lo != 0))."""
    m = mullo32(lo, torch.full_like(lo, neg_pinv))
    t = (hi + umulhi32(m, torch.full_like(m, p)) + (lo != 0).to(hi.dtype)) \
        & MASK32
    return torch.where(t >= p, t - p, t)


def mont_mul(a: torch.Tensor, b: torch.Tensor, p: int,
             neg_pinv: int) -> torch.Tensor:
    """a * b * R^-1 mod p."""
    return mont_redc(umulhi32(a, b), mullo32(a, b), p, neg_pinv)
