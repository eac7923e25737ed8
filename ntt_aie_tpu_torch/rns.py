"""RNS (residue number system) polynomial multiplication.

Port of ``ntt_aie_tpu.rns``: exact convolution of polynomials whose
coefficients pass any word prime. The product runs once in each of k
pairwise-coprime NTT fields (the port's default plans, one batched call
each) and is CRT-reconstructed mod M = prod(p_i) (``ops.crt``: the CUDA
kernel ``csrc/crt.cu`` on the card). It is the exact integer product
whenever every output coefficient lies in (-M/2, M/2], which inputs
bounded by ``max_input_bound()`` guarantee.

With ``mesh=`` every residue field's product runs on the distributed
four-step plan (``parallel.fourstep``) over the mesh's axis 'x', and the
CRT combine on each rank's block (``overlap_chunks`` and ``dp_axis``
forward to the plans). The reference's JAX knobs (``engine``,
``interpret``) do not apply.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ntt_aie_tpu_torch import fields as F
from ntt_aie_tpu_torch.config import NTTConfig
from ntt_aie_tpu_torch.ops.crt import limbs_to_int, make_crt_combine
from ntt_aie_tpu_torch.plan import build_plan
from ntt_aie_tpu_torch.utils.device import resolve_device

DEFAULT_FIELDS = (F.P_2013265921, F.P_998244353, F.P_469762049)


class RNSPolymul:
    """Exact polynomial multiplication over Z via multi-prime NTTs + CRT.

    Usage:
        rns = RNSPolymul(log_n=12)            # M ~ 2^91: inputs up to ~2^39
        c = rns.polymul(a, b)                 # object-int coefficients

    Each field's product runs on its default plan (the four-step fold plan
    above n = 2^16, the flat split up to it; with negacyclic=True the
    negacyclic product), on `device`: None is the card
    (utils.device.resolve_device), "cpu" the plain PyTorch route.

    mesh: a parallel.mesh DeviceMesh (built on every rank) runs every
    field's product on the distributed plan over its axis 'x' at
    rows_log2 = max(log_n // 2, log2 D), as the reference's;
    overlap_chunks forwards to those plans (without a mesh it is not
    used, as in the reference). dp_axis: a 2-D mesh's data-parallel axis;
    (B, n) inputs then split their rows over it. polymul_limbs returns
    this rank's block of limbs, (n1, n2/D, nwords) (or (B/dp, ..)), and
    polymul the whole product (this rank's batch rows with dp_axis),
    gathered over the shard axis.
    """

    def __init__(self, log_n: int, prime_fields: Sequence = DEFAULT_FIELDS,
                 *, negacyclic: bool = False, rows_log2: int | None = None,
                 device=None, mesh=None, overlap_chunks: int = 1,
                 dp_axis: str | None = None):
        self.log_n = log_n
        self.n = 1 << log_n
        self.fields = tuple(prime_fields)
        for f in self.fields:
            if f.p >= (1 << 31):
                raise ValueError(
                    f"RNS residue primes must be < 2^31 (got {f.p}); use "
                    "additional word primes, or goldilocks_plan for native "
                    "mod-p_gl arithmetic")
        for i, f in enumerate(self.fields):
            for g in self.fields[i + 1:]:
                if math.gcd(f.p, g.p) != 1:
                    raise ValueError(
                        f"RNS primes must be pairwise coprime; got {f.p} "
                        f"and {g.p} (duplicate/shared factor would make the "
                        "CRT basis degenerate)")
        self.negacyclic = negacyclic
        self.mesh = mesh
        self.dp_axis = dp_axis
        if mesh is None and dp_axis is not None:
            raise ValueError("dp_axis requires mesh= (a 2D dp x coeff mesh)")
        self.device = resolve_device(device)
        if mesh is None:
            cfg_kw = {} if rows_log2 is None else {"rows_log2": rows_log2}
            self.plans = [
                build_plan(NTTConfig(field=f, log_n=log_n,
                                     negacyclic=negacyclic, **cfg_kw),
                           device=self.device)
                for f in self.fields]
        else:
            from ntt_aie_tpu_torch.parallel.fourstep import (
                build_distributed_plan)
            from ntt_aie_tpu_torch.parallel.mesh import axis_size

            D = axis_size(mesh, "x")
            rows_log2 = max(log_n // 2, D.bit_length() - 1)
            self.plans = [
                build_distributed_plan(
                    NTTConfig(field=f, log_n=log_n, negacyclic=negacyclic,
                              num_shards=D, rows_log2=rows_log2),
                    mesh, device=self.device, overlap_chunks=overlap_chunks,
                    dp_axis=dp_axis)
                for f in self.fields]
        self.modulus = math.prod(f.p for f in self.fields)
        # CRT basis e_i = M_i * (M_i^-1 mod p_i), M_i = M / p_i: the host's
        # object-math combine, which checks the device limbs
        self._basis = []
        for f in self.fields:
            mi = self.modulus // f.p
            self._basis.append(mi * f.inv(mi % f.p))
        # every prime is odd (PrimeField) and < 2^31: the device combine
        # takes any such set
        self._combine, self.nwords = make_crt_combine(self.fields,
                                                      device=self.device)

    def max_input_bound(self) -> int:
        """Largest allowed |coefficient| for exact signed results: outputs
        span (-n*B^2, n*B^2], which the centered lift recovers exactly when
        2 * n * B^2 < M."""
        return math.isqrt((self.modulus - 1) // (2 * self.n)) - 1

    def _residues(self, a) -> list:
        a = np.asarray(a)
        if a.dtype != object and a.dtype.kind not in "iu":
            raise TypeError(f"integer coefficients required, got {a.dtype}")
        bound = self.max_input_bound()
        if not (a.shape == (self.n,)
                or (a.ndim == 2 and a.shape[1] == self.n)):
            raise ValueError(
                f"expected shape ({self.n},) or (B, {self.n}), got {a.shape}")
        lo, hi = int(a.min()), int(a.max())
        if lo < -bound or hi > bound:
            raise ValueError(
                f"coefficients must satisfy |c| <= {bound} for exact "
                f"results (got range [{lo}, {hi}]); use more/larger primes")
        # numpy's % gives nonnegative remainders for signed inputs
        return [(a % f.p).astype(np.uint32) for f in self.fields]

    def _residue_products(self, a, b) -> tuple:
        """Each field's product of the residues of a and b, launched one
        field after another on the device's stream: (products, mat). The
        fields' plans share one split, so all of them or none have the
        matrix-form product (a four-step split has it, a flat one not);
        with mat=True the products are (.., n1, n2) and the caller
        flattens the combined output once."""
        ra_all, rb_all = self._residues(a), self._residues(b)
        batch = ra_all[0].shape[0] if ra_all[0].ndim == 2 else None
        key = "negacyclic_polymul" if self.negacyclic else "polymul"
        if self.mesh is not None:
            if batch is not None and self.dp_axis is None:
                raise ValueError(
                    "batched RNS polymul over a mesh needs dp_axis= "
                    "(a 2D dp x coeff mesh); with a 1D mesh pass one "
                    "(n,) vector per call")
            if batch is None and self.dp_axis is not None:
                raise ValueError(
                    "dp_axis plans take batched (B, n) inputs with B "
                    "divisible by the dp axis size; pass a batch or "
                    "drop dp_axis for single-vector calls")
            return [getattr(plan, key)(plan.shard_input(ra),
                                       plan.shard_input(rb))
                    for plan, ra, rb in zip(self.plans, ra_all, rb_all)], \
                True
        fns = []
        for plan in self.plans:
            calls = (plan.make_batched(batch) if batch is not None else
                     {key: getattr(plan, key),
                      key + "_mat": getattr(plan, key + "_mat")})
            fns.append((calls.get(key + "_mat"), calls[key]))
        mat = fns[0][0] is not None
        if any((f is not None) != mat for f, _ in fns):
            raise RuntimeError("the residue fields' plans disagree on the "
                               "matrix-form product")
        pending = []
        for plan, (f_mat, f_flat), ra, rb in zip(self.plans, fns, ra_all,
                                                 rb_all):
            ta, tb = (torch.from_numpy(r.view(np.int32)).to(self.device)
                      for r in (ra, rb))
            if mat:
                shape = ra.shape[:-1] + plan.config.split
                pending.append(f_mat(ta.reshape(shape), tb.reshape(shape)))
            else:
                pending.append(f_flat(ta, tb))
        return pending, mat

    def polymul_limbs(self, a, b) -> torch.Tensor:
        """Exact product with the CRT combine on the device: an (n, nwords)
        -- or (B, n, nwords) for batched (B, n) inputs -- int32 tensor of
        the uint32 little-endian limbs of the centered representative in
        (-M/2, M/2], two's-complement encoded (ops.crt). The residue
        products and the combine run without a host round trip;
        ``limbs_to_int`` turns limbs into Python ints (what ``polymul``
        does)."""
        pending, mat = self._residue_products(a, b)
        out = self._combine(*pending)
        if mat and self.mesh is None:
            lead = out.shape[:-3]
            out = out.reshape(lead + (self.n, self.nwords))
        return out

    def polymul(self, a, b) -> np.ndarray:
        """Exact cyclic (or negacyclic) product of signed-integer-coefficient
        polynomials; inputs must be ints with |c| <= max_input_bound().
        Output coefficients are exact signed integers (centered lift).
        Over a mesh, every rank gets the whole product (of its batch rows
        with dp_axis)."""
        limbs = self.polymul_limbs(a, b)
        if self.mesh is not None:
            limbs = self.plans[0].gather(limbs, dim=-2)
            limbs = limbs.reshape(limbs.shape[:-3] + (self.n, self.nwords))
        return limbs_to_int(limbs)
