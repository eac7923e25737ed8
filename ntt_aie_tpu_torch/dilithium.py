"""ML-DSA (FIPS 204 / Dilithium) NTT over Z_8380417[X]/(X^256 + 1).

Port of ``ntt_aie_tpu.dilithium``. q = 8380417 has 512th roots of unity
(zeta = 1753), so the ML-DSA NTT is complete: 8 layers down to len = 1,
coefficient-wise products in the NTT domain, and the standard's BitRev8
zeta order (FIPS 204 Algorithms 41-45); the NTT-domain values are the
standard's bit for bit.

Arithmetic: Montgomery REDC (R = 2^32, ``ops.modops.mont_mul``) against
zeta tables premultiplied into Montgomery form, so mont_mul(value,
zeta R) = value zeta mod q.

On a CUDA tensor each function is one launch of a kernel of
``csrc/ring_layers.cu``: ``dilithium_ntt``/``dilithium_intt`` the layered
transform (``ops.ring_layers.layered``), ``dilithium_pointwise``,
``dilithium_polymul``, ``dilithium_matvec``, ``dilithium_serve`` and
``dilithium_serving_step`` the fused ring product
(``ops.ring_layers.ring_product``; the serving step with one matrix for
the whole batch is two launches). On a CPU tensor they run the plain
versions (``ring_layers.layered_fwd``/``layered_inv``, the pointwise
product and matvec as torch ops on int64 carriers). Every function takes
(..., 256) values in [0, q), batched or single, and returns an int32
tensor; the device rule is ``ring_layers``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from ntt_aie_tpu_torch import fields as F
from ntt_aie_tpu_torch import ring_layers as RL
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops import ring_layers as LR
from ntt_aie_tpu_torch.utils.device import resolve_device

Q = 8380417
ZETA = 1753
N = 256
_FIELD = F.DILITHIUM
_NEG_PINV = _FIELD.mont_neg_pinv
_R2 = _FIELD.mont_r2_mod_p

_ZETAS = RL.layer_zeta_tables(ZETA, Q, 8, 8, post=_FIELD.to_mont)
_IZETAS = RL.layer_zeta_tables(ZETA, Q, 8, 8, inverse=True,
                               post=_FIELD.to_mont)
_N_INV_MONT = np.uint32(_FIELD.to_mont(F.modpow(256, Q - 2, Q)))


def _mulz(a, z):
    """a * zeta for Montgomery-form zeta tables."""
    return M.mont_mul(a, z, Q, _NEG_PINV)


def _fixup(raw: torch.Tensor) -> torch.Tensor:
    """raw * R^2 * R^-1: takes back the R^-1 of one raw mont_mul."""
    return M.mont_mul(raw, torch.full_like(raw, _R2), Q, _NEG_PINV)


def _pointwise_plain(ahat: torch.Tensor, bhat: torch.Tensor) -> torch.Tensor:
    """mont_mul, then the R^2 fix-up, in torch ops on int32 tensors (the
    plain version)."""
    a, b = M.to_carrier(ahat), M.to_carrier(bhat)
    return M.from_carrier(_fixup(M.mont_mul(a, b, Q, _NEG_PINV)))


def _matvec_plain(ahat: torch.Tensor, yhat: torch.Tensor) -> torch.Tensor:
    """The NTT-domain matvec in torch ops (the plain version). The R^-1
    of a raw mont_mul commutes with the sum, so the terms accumulate
    unfixed and the R^2 fix-up runs once on the sum (l + 1 multiplies a
    coefficient instead of 2l)."""
    a, y = M.to_carrier(ahat), M.to_carrier(yhat)
    raw = RL.matvec_terms(a, y, lambda u, v: M.mont_mul(u, v, Q, _NEG_PINV),
                          lambda u, v: M.add_mod(u, v, Q))
    return M.from_carrier(_fixup(raw))


SCHEME = LR.Scheme(name="dilithium", q=Q, n=N, zetas=tuple(_ZETAS),
                   izetas=tuple(_IZETAS), scale=int(_N_INV_MONT),
                   mulz=_mulz, pointwise_plain=_pointwise_plain,
                   matvec_plain=_matvec_plain,
                   product_scale=_FIELD.to_mont(int(_N_INV_MONT)),
                   fixup=_R2, neg_pinv=_NEG_PINV)


def dilithium_ntt(f) -> torch.Tensor:
    """FIPS 204 Algorithm 41 over the last axis (length 256)."""
    return LR.layered(f, SCHEME)


def dilithium_intt(fhat) -> torch.Tensor:
    """FIPS 204 Algorithm 42 (inverse layers in reverse, 1/256 scale)."""
    return LR.layered(fhat, SCHEME, inverse=True)


def dilithium_pointwise(ahat, bhat) -> torch.Tensor:
    """Coefficient-wise product in the NTT domain (FIPS 204 Algorithm 45;
    the complete NTT needs no basemul)."""
    return LR.ring_product(ahat, bhat, SCHEME, "pointwise")


def dilithium_polymul(a, b) -> torch.Tensor:
    """a * b in Z_8380417[X]/(X^256 + 1) via the ML-DSA pipeline:
    intt(pointwise(ntt(a), ntt(b)))."""
    return LR.ring_product(a, b, SCHEME, "product")


def dilithium_matvec(ahat, yhat) -> torch.Tensor:
    """Module-lattice matrix-vector product in the NTT domain, the ML-DSA
    serving primitive (w = A y in Sign, A z in Verify; FIPS 204
    Algorithms 7-8). ahat: (..., k, l, 256), yhat: (..., l, 256); returns
    (..., k, 256) = sum_j ahat[..., i, j, :] * yhat[..., j, :]
    coefficient-wise."""
    return LR.ring_product(yhat, ahat, SCHEME, "matvec")


def dilithium_serve(ahat, y) -> torch.Tensor:
    """intt(matvec(ahat, ntt(y))): the serving step against an NTT-domain
    matrix (one key's A_hat against a batch of vectors)."""
    return LR.ring_product(y, ahat, SCHEME, "serve")


def dilithium_serving_step(A, y) -> torch.Tensor:
    """intt(matvec(ntt(A), ntt(y))): the serving step with a fresh A."""
    return LR.ring_product(y, A, SCHEME, "serve_fresh")


def make_pipeline(device=None) -> dict:
    """The ML-DSA serving bundle on `device` (None: the card,
    RuntimeError without one; ring_layers.make_pipeline). The ML-DSA-65
    serving step is make_pipeline()["make_serving_step"](A_hat) with
    A_hat (k=6, l=5, 256) applied to (B, 5, 256) batches, giving
    (B, 6, 256)."""
    return RL.make_pipeline(dilithium_ntt, dilithium_intt, dilithium_matvec,
                            dilithium_polymul, dilithium_pointwise,
                            dilithium_serve, dilithium_serving_step,
                            resolve_device(device))
