"""Modular arithmetic on int64 tensors that carry uint32 values.

Twins of ``ntt_aie_tpu.ops.modops``. PyTorch's CPU uint32 has no ``+``,
``>>`` or ``<``, so every value here is an int64 tensor holding a uint32
bit pattern in [0, 2^32), and every result is masked back to 32 bits: the
results equal the reference's uint32 results bit for bit, wrap-around
included. A full 32x32 product does not fit int64, so high and low words
are assembled from 16-bit limbs as the reference does.

Goldilocks values p = 2^64 - 2^32 + 1 travel as (hi, lo) pairs of such
carriers; the ``gl_*`` twins keep them canonical, [0, p), at every step.
On the host, ``gl_from_u64``/``gl_to_u64`` split and join NumPy uint64
arrays into int32 limb planes (torch's uint64 is not relied on).
"""

from __future__ import annotations

import numpy as np
import torch

from ntt_aie_tpu_torch.utils.device import resolve_device

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


def barrett_mul(a: torch.Tensor, b: torch.Tensor, p: int, w: int,
                u: int) -> torch.Tensor:
    """a * b mod p by the reference's Barrett "2k" (src/aie_core.cc:27-39)
    for p < 2^14: t = a*b, x1 = t >> (w-2), s = (x1*u) >> (w+2),
    c = t - s*p, one conditional subtract. Each step is masked to 32 bits
    as the reference's uint32 operations wrap; canonical inputs never
    wrap."""
    t = mullo32(a, b)
    s = mullo32(t >> (w - 2), torch.full_like(t, u)) >> (w + 2)
    c = (t - s * p) & MASK32
    return torch.where(c >= p, c - p, c)


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


# ---- Goldilocks p = 2^64 - 2^32 + 1 on (hi, lo) limb carriers -------------

GL_P = (1 << 64) - (1 << 32) + 1


def umul32_wide(a: torch.Tensor, b: torch.Tensor):
    """(hi, lo) of the 64-bit product of two uint32 values."""
    return umulhi32(a, b), mullo32(a, b)


def _add3_with_carry(x, y, z):
    """x + y + z over uint32, returning (sum, carry in {0, 1, 2})."""
    s = x + y + z
    return s & MASK32, s >> 32


def gl_canonical(hi, lo):
    """Subtract p once where (hi, lo) >= p (inputs < 2p fold to [0, p))."""
    ge = (hi == MASK32) & (lo >= 1)
    return torch.where(ge, (hi - MASK32 - (lo < 1).long()) & MASK32, hi), \
        torch.where(ge, (lo - 1) & MASK32, lo)


def gl_add(ahi, alo, bhi, blo):
    """(a + b) mod p for a, b in [0, p). A carry out of 2^64 adds
    eps = 2^32 - 1, which cannot wrap again (the wrapped sum is < p)."""
    lo = alo + blo
    hi = ahi + bhi + (lo >> 32)
    lo = lo & MASK32
    wrap = (hi >> 32) != 0
    hi = hi & MASK32
    lo_w = lo + MASK32
    hi_w = (hi + (lo_w >> 32)) & MASK32
    return gl_canonical(torch.where(wrap, hi_w, hi),
                        torch.where(wrap, lo_w & MASK32, lo))


def gl_sub(ahi, alo, bhi, blo):
    """(a - b) mod p for a, b in [0, p). A borrow out of 2^64 subtracts
    eps = 2^32 - 1 (-2^64 = -eps mod p)."""
    lo = alo - blo
    hi = ahi - bhi - (lo < 0).long()
    lo = lo & MASK32
    under = hi < 0
    hi = hi & MASK32
    lo_u = lo - MASK32
    hi_u = (hi - (lo_u < 0).long()) & MASK32
    return gl_canonical(torch.where(under, hi_u, hi),
                        torch.where(under, lo_u & MASK32, lo))


def _gl_reduce128(r3, r2, r1, r0):
    """(r3:r2:r1:r0) mod p via 2^64 = eps, 2^96 = -1; canonical output:
    x = (r1:r0) - r3 + r2 * eps (mod p)."""
    # t = (r1:r0) - r3, adding p on a borrow out of 2^64
    tlo = r0 - r3
    thi = r1 - (tlo < 0).long()
    tlo = tlo & MASK32
    under = thi < 0
    thi = thi & MASK32
    plo = tlo + 1
    phi = (thi + MASK32 + (plo >> 32)) & MASK32
    thi = torch.where(under, phi, thi)
    tlo = torch.where(under, plo & MASK32, tlo)
    # u = r2 * eps = (r2 << 32) - r2 = (r2 - (r2 != 0), -r2)
    uhi = r2 - (r2 != 0).long()
    ulo = (-r2) & MASK32
    # s = t + u, a 2^64 wrap adding eps
    lo = tlo + ulo
    hi = thi + uhi + (lo >> 32)
    lo = lo & MASK32
    wrap = (hi >> 32) != 0
    hi = hi & MASK32
    lo_w = lo + MASK32
    hi_w = (hi + (lo_w >> 32)) & MASK32
    return gl_canonical(torch.where(wrap, hi_w, hi),
                        torch.where(wrap, lo_w & MASK32, lo))


def gl_mul(ahi, alo, bhi, blo):
    """(a * b) mod p on limb pairs: four 32x32 -> 64 products (16-bit
    limbs) assembled into 128 bits (r3, r2, r1, r0), then _gl_reduce128."""
    h00, l00 = umul32_wide(alo, blo)
    h01, l01 = umul32_wide(alo, bhi)
    h10, l10 = umul32_wide(ahi, blo)
    h11, l11 = umul32_wide(ahi, bhi)
    r1, c1 = _add3_with_carry(h00, l01, l10)
    r2, c2 = _add3_with_carry(h01, h10, l11 + c1)
    r3 = h11 + c2  # < 2^32: the full product is < 2^128
    return _gl_reduce128(r3, r2, r1, l00)


def gl_from_u64(x, device=None):
    """NumPy uint64 array-like -> (hi, lo) torch.int32 limb planes (uint32
    bit patterns) on `device` (None: the card)."""
    device = resolve_device(device)
    x = np.asarray(x, dtype=np.uint64)
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return tuple(torch.from_numpy(np.ascontiguousarray(v).view(np.int32))
                 .to(device) for v in (hi, lo))


def gl_to_u64(hi: torch.Tensor, lo: torch.Tensor) -> np.ndarray:
    """(hi, lo) int32 limb planes -> NumPy uint64 array on the host."""
    hi, lo = (v.cpu().numpy().view(np.uint32).astype(np.uint64)
              for v in (hi, lo))
    return (hi << np.uint64(32)) | lo
