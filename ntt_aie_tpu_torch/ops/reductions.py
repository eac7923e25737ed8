"""Reduction strategies: how butterflies multiply, on int64-carrier tensors.

Twin of ``ntt_aie_tpu.ops.reductions``. A ``Reduction`` bundles the host
table preparation (NumPy, identical to the reference's) and the tensor
arithmetic of one strategy. Tensor arguments and results are int64
tensors carrying uint32 values (``ops.modops``); every function returns
the reference's uint32 result bit for bit, except ``mul_data``, whose
contract is the canonical product.

- harvey4: p < 2^29, values travel in the lazy domain [0, 4p), and a
  constant multiply is the approximate Shoup product from three 16-bit
  partials of w' = floor(w * 2^32 / p) (q may fall short by up to 2, which
  lands the product in [0, 4p)). ``sub_for_mul`` and ``add_for_mul``
  reach [0, 8p) < 2^32, legal only as mul_const input; ``canonicalize``
  is two conditional subtracts, 2p then p.
- harvey: p < 2^30, the lazy domain [0, 2p), the exact Shoup product
  q = umulhi(x, w'), x*w - q*p in [0, 2p) for any x < 2^32;
  ``sub_for_mul``/``add_for_mul`` reach [0, 4p); ``canonicalize`` is one
  conditional subtract of p.
- montgomery: odd p < 2^31, the canonical domain; a table holds w*R mod p
  (R = 2^32) and a constant multiply is one REDC, which returns x*w mod p.
- barrett: p < 2^14, the canonical domain; the reference's Barrett "2k".

The canonical kinds add and subtract with ``add_mod``/``sub_mod`` and
``canonicalize`` is the identity.

The kernels take every table as one (w, w2) uint32 pair a twiddle
(``Reduction.pair``): harvey4 (w, packed w'), harvey (w, w'), montgomery
(w*R mod p, 0), barrett (w, 0); ``mulc_mat(x, w, w2)`` multiplies by a
pair for all four.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops.modops import MASK16, MASK32

@dataclasses.dataclass(frozen=True)
class Reduction:
    name: str
    p: int
    lazy: bool
    n_tables: int
    prepare_table: Callable  # np int64 table -> tuple of np.uint32
    mul_const: Callable      # (x, *tables) -> x*w in the lazy domain
    mul_data: Callable       # (x, y) lazy inputs -> canonical product
    add: Callable
    sub: Callable
    canonicalize: Callable
    sub_for_mul: Callable | None = None
    add_for_mul: Callable | None = None
    # Full-matrix operand form (harvey4: w plus the Shoup halves packed
    # into one uint32 table, (wh << 16) | wl).
    n_tables_mat: int | None = None
    prepare_table_mat: Callable | None = None
    mul_const_mat: Callable | None = None
    # The two constants the kernels take beside p (csrc/reductions.cuh):
    # montgomery (-p^-1 mod 2^32, 0), barrett (w, u), else (0, 0).
    consts: tuple = (0, 0)

    @property
    def mat_tables(self) -> int:
        return self.n_tables_mat or self.n_tables

    @property
    def prep_mat(self) -> Callable:
        return self.prepare_table_mat or self.prepare_table

    @property
    def mulc_mat(self) -> Callable:
        return self.mul_const_mat or self.mul_const

    def pair(self, t) -> tuple:
        """The kernels' form of table t: a (w, w2) pair of uint32 arrays of
        t's shape, the second zero where the strategy needs one table."""
        tabs = self.prep_mat(np.asarray(t))
        if len(tabs) == 1:
            tabs = (tabs[0], np.zeros_like(tabs[0]))
        return tuple(np.ascontiguousarray(v) for v in tabs)


def canonical_product(p):
    """Every 32-bit kind's mul_data, and the plain version of
    ops.pointwise.mul32: the exact product on int64 carriers."""
    def muld(x, y):
        # exact canonical product: (x mod p) * (y mod p) < 2^62
        return (x % p) * (y % p) % p
    return muld


def _canonical(name, field, prep, mulc, consts) -> Reduction:
    """A strategy whose values stay canonical, [0, p): one table a
    twiddle, add/sub by one conditional subtract."""
    p = field.p
    return Reduction(
        name=name, p=p, lazy=False, n_tables=1,
        prepare_table=prep, mul_const=mulc,
        mul_data=canonical_product(p),
        add=lambda a, b: M.add_mod(a, b, p),
        sub=lambda a, b: M.sub_mod(a, b, p),
        canonicalize=lambda x: x,
        mul_const_mat=lambda x, w, _w2: mulc(x, w), consts=consts,
    )


def _barrett(field) -> Reduction:
    if not field.supports_barrett32:
        raise ValueError(f"barrett requires p < 2^14, got {field.p}")
    p, w_, u_ = field.p, field.barrett_w, field.barrett_u

    def prep(t):
        return (np.ascontiguousarray(np.asarray(t).astype(np.uint32)),)

    def mulc(x, w):
        return M.barrett_mul(x, w, p, w_, u_)

    return _canonical("barrett", field, prep, mulc, (w_, u_))


def _montgomery(field) -> Reduction:
    if not field.supports_mont32:
        raise ValueError(f"montgomery requires an odd p < 2^31, got "
                         f"{field.p}")
    p, neg_pinv, r = field.p, field.mont_neg_pinv, field.mont_r_mod_p

    def prep(t):
        # values < p < 2^31 and r < 2^31: the uint64 product is exact
        t64 = np.asarray(t).astype(np.uint64)
        return (((t64 * np.uint64(r)) % np.uint64(p)).astype(np.uint32),)

    def mulc(x, w):
        return M.mont_mul(x, w, p, neg_pinv)

    return _canonical("montgomery", field, prep, mulc, (neg_pinv, 0))


def _harvey(field) -> Reduction:
    p = field.p
    if p >= (1 << 30):
        raise ValueError(f"harvey requires p < 2^30, got {p}")
    p2 = 2 * p

    def prep(t):
        # w < p < 2^30, so (w << 32) < 2^62 is exact in uint64
        t64 = np.asarray(t).astype(np.uint64)
        w = t64.astype(np.uint32)
        ws = ((t64 << np.uint64(32)) // np.uint64(p)).astype(np.uint32)
        return (np.ascontiguousarray(w), np.ascontiguousarray(ws))

    def mulc(x, w, ws):
        # exact Shoup: q = umulhi(x, w') <= x*w/p, so x*w - q*p is in
        # [0, 2p) for any x < 2^32; x*w and q*p are below 2^62
        return (x * w - M.umulhi32(x, ws) * p) & MASK32

    def add(a, b):
        s = (a + b) & MASK32
        return torch.where(s >= p2, s - p2, s)

    def sub(a, b):
        d = (a + ((p2 - b) & MASK32)) & MASK32
        return torch.where(d >= p2, d - p2, d)

    def sub_lazy(a, b):
        return (a + ((p2 - b) & MASK32)) & MASK32

    def add_lazy(a, b):
        return (a + b) & MASK32

    def canon(x):
        return torch.where(x >= p, x - p, x)

    return Reduction(
        name="harvey", p=p, lazy=True, n_tables=2,
        prepare_table=prep, mul_const=mulc,
        mul_data=canonical_product(p),
        add=add, sub=sub, canonicalize=canon, sub_for_mul=sub_lazy,
        add_for_mul=add_lazy,
    )


def _harvey4(field) -> Reduction:
    p = field.p
    if p >= (1 << 29):
        raise ValueError(f"harvey4 requires p < 2^29, got {p}")
    p2, p4 = 2 * p, 4 * p

    def prep(t):
        # w and the pre-split 16-bit halves of w' = floor(w * 2^32 / p)
        t64 = np.asarray(t).astype(np.uint64)
        w = t64.astype(np.uint32)
        ws = (t64 << np.uint64(32)) // np.uint64(p)
        wh = (ws >> np.uint64(16)).astype(np.uint32)
        wl = (ws & np.uint64(0xFFFF)).astype(np.uint32)
        return (np.ascontiguousarray(w), np.ascontiguousarray(wh),
                np.ascontiguousarray(wl))

    def prep_mat(t):
        w, wh, wl = prep(t)
        return (w, np.ascontiguousarray((wh << np.uint32(16)) | wl))

    def mulc(x, w, wh, wl):
        # q = xh*wh + (xl*wh >> 16) + (xh*wl >> 16) <= floor(x*w'/2^32),
        # so q < 2^32 and x*w, q*p < 2^61: exact in int64 before the mask
        xl, xh = x & MASK16, x >> 16
        q = xh * wh + ((xl * wh) >> 16) + ((xh * wl) >> 16)
        return (x * w - q * p) & MASK32

    def mulc_mat(x, w, packed):
        return mulc(x, w, packed >> 16, packed & MASK16)

    def add(a, b):
        s = (a + b) & MASK32
        return torch.where(s >= p4, s - p4, s)

    def sub(a, b):
        d = (a + ((p4 - b) & MASK32)) & MASK32
        return torch.where(d >= p4, d - p4, d)

    def sub_lazy(a, b):
        return (a + ((p4 - b) & MASK32)) & MASK32

    def add_lazy(a, b):
        return (a + b) & MASK32

    def canon(x):
        x = torch.where(x >= p2, x - p2, x)
        return torch.where(x >= p, x - p, x)

    return Reduction(
        name="harvey4", p=p, lazy=True, n_tables=3,
        prepare_table=prep, mul_const=mulc,
        mul_data=canonical_product(p),
        add=add, sub=sub, canonicalize=canon, sub_for_mul=sub_lazy,
        add_for_mul=add_lazy,
        n_tables_mat=2, prepare_table_mat=prep_mat, mul_const_mat=mulc_mat,
    )


_MAKERS = {"barrett": _barrett, "montgomery": _montgomery,
           "harvey": _harvey, "harvey4": _harvey4}


def make_reduction(kind: str, field) -> Reduction:
    """The strategy of this kind over `field`. Goldilocks has none, as in
    the reference (build_plan routes it to goldilocks_plan): 'goldilocks'
    raises ValueError like any unknown kind."""
    if kind not in _MAKERS:
        raise ValueError(f"unknown reduction kind {kind!r}")
    return _MAKERS[kind](field)


def resolve_kind(config_reduction: str, field) -> str:
    """'auto' prefers the fewest-multiply strategy the prime admits:
    harvey4 (p < 2^29) > harvey (p < 2^30) > montgomery."""
    if config_reduction != "auto":
        return config_reduction
    if field.supports_barrett32:
        return "barrett"
    if field.p < (1 << 29) and field.p % 2 == 1:
        return "harvey4"
    if field.p < (1 << 30) and field.p % 2 == 1:
        return "harvey"
    if field.supports_mont32:
        return "montgomery"
    if field.is_goldilocks:
        return "goldilocks"
    raise ValueError(f"no reduction strategy for p={field.p}")
