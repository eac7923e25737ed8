"""Reduction strategies: how butterflies multiply, on int64-carrier tensors.

Twin of ``ntt_aie_tpu.ops.reductions``. A ``Reduction`` bundles the host
table preparation (NumPy, identical to the reference's) and the tensor
arithmetic of one strategy. Tensor arguments and results are int64
tensors carrying uint32 values (``ops.modops``); every function returns
the reference's uint32 result bit for bit, except ``mul_data``, whose
contract is the canonical product.

Only harvey4 is ported: p < 2^29, values travel in the lazy domain
[0, 4p), and a constant multiply is the approximate Shoup product from
three 16-bit partials of w' = floor(w * 2^32 / p) (q may fall short by
up to 2, which lands the product in [0, 4p)). ``sub_for_mul`` and
``add_for_mul`` reach [0, 8p) < 2^32, legal only as mul_const input;
``canonicalize`` is two conditional subtracts, 2p then p.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ntt_aie_tpu_torch.ops.modops import MASK16, MASK32

# ROADMAP.md items that port the other strategies, by reduction kind.
_NOT_PORTED = {
    "barrett": "Queue 1 item 2 (barrett) and item 4i",
    "montgomery": "Queue 1 item 2 (montgomery) and item 4i",
    "harvey": "Queue 1 item 2 (harvey)",
    "goldilocks": "Queue 1 item 7 (Goldilocks has no Reduction: "
                  "build_plan routes it to goldilocks_plan)",
}


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

    @property
    def mat_tables(self) -> int:
        return self.n_tables_mat or self.n_tables

    @property
    def prep_mat(self) -> Callable:
        return self.prepare_table_mat or self.prepare_table

    @property
    def mulc_mat(self) -> Callable:
        return self.mul_const_mat or self.mul_const


def make_reduction(kind: str, field) -> Reduction:
    p = field.p
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"reduction {kind!r} is not ported yet: ROADMAP.md "
            f"{_NOT_PORTED[kind]}")
    if kind != "harvey4":
        raise ValueError(f"unknown reduction kind {kind!r}")
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

    def muld(x, y):
        # exact canonical product: (x mod p) * (y mod p) < 2^58
        return (x % p) * (y % p) % p

    return Reduction(
        name="harvey4", p=p, lazy=True, n_tables=3,
        prepare_table=prep, mul_const=mulc, mul_data=muld,
        add=add, sub=sub, canonicalize=canon, sub_for_mul=sub_lazy,
        add_for_mul=add_lazy,
        n_tables_mat=2, prepare_table_mat=prep_mat, mul_const_mat=mulc_mat,
    )


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
