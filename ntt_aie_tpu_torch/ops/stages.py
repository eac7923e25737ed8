"""Butterfly stage loops over (rows, columns) matrices: the flat transform
in plain PyTorch ops.

Twin of ``ntt_aie_tpu.ops.stages`` (``dif_stages``/``dit_stages``) and of
the reference Goldilocks plan's ``gl_dif_stages``/``gl_dit_stages``
(``ntt_aie_tpu/goldilocks_plan.py:54-98``). Each runs every radix-2 stage
along axis 0 of an (n, C) int64 carrier (``ops.modops``), the columns
being independent transforms, with the stage twiddles packed as
``twiddles.pack_stage_twiddles`` packs them, and returns the reference's
values bit for bit, lazy domain included.

``reference_network_stages`` is the reference-parity network
(``plan.build_plan`` with table_convention='reference' runs it; no kernel
exists for it in the reference either).

``FlatStages`` (``make_flat_stages``) is the reference's flat plan
(``ntt_aie_tpu/plan.py:582-655``, its Goldilocks twin ``:353-388``) on a
(B, n) batch: the batch transposed onto the columns, DIF forward
(natural in, bit-reversed out), DIT inverse with the 1/n scale, canonical
outputs. It is the plain version of the flat transform, the oracle that
the flat plans' card route (``plan.build_plan`` at n2 = 1: the four-step
kernels at an internal split, then one gather) is held against; only
n = 2, which has no two-factor split, runs it as its plan
(``plan.flat_n2_plan``), on either device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops.reductions import Reduction, make_reduction
from ntt_aie_tpu_torch.utils.device import resolve_device


def dif_stages(x: torch.Tensor, tw_packed: tuple,
               red: Reduction) -> torch.Tensor:
    """Gentleman-Sande DIF along axis 0: natural row order in, bit-reversed
    out. x: (n, C) carrier; tw_packed: the reduction's tables of the
    packed stage twiddles, each a (log2 n, n//2) carrier. Stage s pairs
    rows (j, j + t), t = n >> (s+1): (u + v, (u - v) * w), in the
    reduction's domain."""
    n, c = x.shape
    subm = red.sub_for_mul or red.sub
    for s in range(n.bit_length() - 1):
        t = n >> (s + 1)
        blocks = n // (2 * t)
        xr = x.reshape(blocks, 2, t, c)
        u, v = xr[:, 0], xr[:, 1]
        ws = tuple(tp[s].reshape(blocks, t, 1) for tp in tw_packed)
        x = torch.stack((red.add(u, v), red.mul_const(subm(u, v), *ws)),
                        dim=1).reshape(n, c)
    return x


def dit_stages(x: torch.Tensor, tw_packed: tuple,
               red: Reduction) -> torch.Tensor:
    """Cooley-Tukey DIT along axis 0: bit-reversed row order in, natural
    out. Stage s, t = 2^s: (u + w*v, u - w*v)."""
    n, c = x.shape
    for s in range(n.bit_length() - 1):
        t = 1 << s
        blocks = n // (2 * t)
        xr = x.reshape(blocks, 2, t, c)
        u, v = xr[:, 0], xr[:, 1]
        ws = tuple(tp[s].reshape(blocks, t, 1) for tp in tw_packed)
        wv = red.mul_const(v, *ws)
        x = torch.stack((red.add(u, wv), red.sub(u, wv)),
                        dim=1).reshape(n, c)
    return x


def reference_network_stages(x: torch.Tensor, table: tuple, red: Reduction,
                             stages: int | None = None) -> torch.Tensor:
    """The reference device's network (its src/test.cpp:34-60) on a flat
    (n,) carrier: increasing stride t = 2^s, stage s pairing (j, j + t)
    in each of h = n >> (s+1) groups, group i's butterfly (u + v,
    (u - v) * table[h + i]) in the reduction's domain. table: the
    reduction's tables of the length-n table, (n,) carriers. stages: run
    stages 0..stages inclusive; None is full depth. Canonical output.
    Twin of the reference's ``reference_network_stages`` (its
    ``ops/stages.py:73-92``)."""
    n = x.shape[0]
    for s in range(n.bit_length() - 1):
        t, h = 1 << s, n >> (s + 1)
        xr = x.reshape(h, 2, t)
        u, v = xr[:, 0], xr[:, 1]
        roots = tuple(tp[h:2 * h].reshape(h, 1) for tp in table)
        x = torch.stack((red.add(u, v), red.mul_const(red.sub(u, v), *roots)),
                        dim=1).reshape(n)
        if stages is not None and s == stages:
            break
    return red.canonicalize(x)


def gl_dif_stages(h: torch.Tensor, l: torch.Tensor, twh: torch.Tensor,
                  twl: torch.Tensor) -> tuple:
    """DIF along axis 0 on Goldilocks (hi, lo) carriers of shape (n, C);
    twh/twl: the packed stage twiddles' limbs, (log2 n, n//2)."""
    n, c = h.shape
    for s in range(n.bit_length() - 1):
        t = n >> (s + 1)
        blocks = n // (2 * t)
        hr, lr = h.reshape(blocks, 2, t, c), l.reshape(blocks, 2, t, c)
        uh, ul, vh, vl = hr[:, 0], lr[:, 0], hr[:, 1], lr[:, 1]
        ah, al = M.gl_add(uh, ul, vh, vl)
        bh, bl = M.gl_mul(*M.gl_sub(uh, ul, vh, vl),
                          twh[s].reshape(blocks, t, 1),
                          twl[s].reshape(blocks, t, 1))
        h = torch.stack((ah, bh), dim=1).reshape(n, c)
        l = torch.stack((al, bl), dim=1).reshape(n, c)
    return h, l


def gl_dit_stages(h: torch.Tensor, l: torch.Tensor, twh: torch.Tensor,
                  twl: torch.Tensor) -> tuple:
    """DIT along axis 0 on Goldilocks (hi, lo) carriers; bit-reversed in,
    natural out."""
    n, c = h.shape
    for s in range(n.bit_length() - 1):
        t = 1 << s
        blocks = n // (2 * t)
        hr, lr = h.reshape(blocks, 2, t, c), l.reshape(blocks, 2, t, c)
        uh, ul, vh, vl = hr[:, 0], lr[:, 0], hr[:, 1], lr[:, 1]
        wvh, wvl = M.gl_mul(vh, vl, twh[s].reshape(blocks, t, 1),
                            twl[s].reshape(blocks, t, 1))
        ah, al = M.gl_add(uh, ul, wvh, wvl)
        bh, bl = M.gl_sub(uh, ul, wvh, wvl)
        h = torch.stack((ah, bh), dim=1).reshape(n, c)
        l = torch.stack((al, bl), dim=1).reshape(n, c)
    return h, l


@dataclasses.dataclass(frozen=True, eq=False)
class FlatStages:
    """The flat transform of n points: its stage tables and 1/n, prepared
    once as int64 carriers on one device.

    red: the 32-bit reduction, or None for Goldilocks.
    tw, itw: the forward DIF and inverse DIT stage tables, each a tuple of
      (log2 n, n//2) carriers (the reduction's ``prepare_table`` form; the
      (hi, lo) limbs for Goldilocks).
    scale: 1/n in the same form, each (1, 1).
    """

    n: int
    red: Reduction | None
    tw: tuple
    itw: tuple
    scale: tuple

    def fwd(self, x):
        """The flat forward transform of each row: natural in,
        bit-reversed out, canonical (reference ``plan.py`` ``fwd_cols``).
        x: (B, n) or (n,) int32, or a (hi, lo) pair of them."""
        cols, back = _columns(x, self)
        if self.red is None:
            return back(gl_dif_stages(*cols, *self.tw))
        red = self.red
        return back((red.canonicalize(dif_stages(cols[0], self.tw, red)),))

    def inv(self, x):
        """The flat inverse transform of each row: bit-reversed in,
        natural out, times 1/n, canonical (reference ``inv_cols``)."""
        cols, back = _columns(x, self)
        if self.red is None:
            return back(M.gl_mul(*gl_dit_stages(*cols, *self.itw),
                                 *self.scale))
        red = self.red
        v = red.mul_const(dit_stages(cols[0], self.itw, red), *self.scale)
        return back((red.canonicalize(v),))


def _carriers(tabs, shape, device) -> tuple:
    return tuple(torch.from_numpy(np.asarray(t).astype(np.int64)
                                  .reshape(shape)).to(device) for t in tabs)


def _gl_limbs(t) -> tuple:
    t = np.asarray(t, dtype=np.uint64)
    return t >> np.uint64(32), t & np.uint64(0xFFFFFFFF)


def make_flat_stages(field, n: int, *, reduction: str = "harvey4",
                     device=None) -> FlatStages:
    """The flat transform of n points over `field` under the reduction of
    this kind ('goldilocks' for p = 2^64 - 2^32 + 1), with its tables on
    `device` (None: the card)."""
    device = resolve_device(device)
    logn = n.bit_length() - 1
    shape = (logn, n // 2)
    fwd_t = tw.pack_stage_twiddles(tw.dif_stage_twiddles(field, n), n)
    inv_t = tw.pack_stage_twiddles(
        tw.dit_stage_twiddles(field, n, inverse=True), n)
    n_inv = np.full(1, field.inv(n), dtype=np.uint64)
    if reduction == "goldilocks":
        return FlatStages(n=n, red=None,
                          tw=_carriers(_gl_limbs(fwd_t), shape, device),
                          itw=_carriers(_gl_limbs(inv_t), shape, device),
                          scale=_carriers(_gl_limbs(n_inv), (1, 1), device))
    red = make_reduction(reduction, field)
    return FlatStages(
        n=n, red=red,
        tw=_carriers(red.prepare_table(fwd_t), shape, device),
        itw=_carriers(red.prepare_table(inv_t), shape, device),
        scale=_carriers(red.prepare_table(n_inv.astype(np.int64)), (1, 1),
                        device))


def _columns(x, fs: FlatStages):
    """(B, n) or (n,) int32 tensor, or a (hi, lo) pair of them -> tuple of
    (n, B) carriers, and the function that takes carriers back."""
    planes = x if isinstance(x, tuple) else (x,)
    if (fs.red is None) != isinstance(x, tuple):
        raise TypeError("the Goldilocks flat transform takes a (hi, lo) "
                        "tuple of int32 tensors, the 32-bit one a tensor")
    shape = planes[0].shape
    if shape[-1] != fs.n or len(shape) not in (1, 2):
        raise ValueError(f"the flat transform of {fs.n} points takes (B, "
                         f"{fs.n}) or ({fs.n},), got {tuple(shape)}")
    cols = tuple(M.to_carrier(v).reshape(-1, fs.n).t() for v in planes)

    def back(vs):
        out = tuple(M.from_carrier(v.t()).reshape(shape).contiguous()
                    for v in vs)
        return out if isinstance(x, tuple) else out[0]

    return cols, back
