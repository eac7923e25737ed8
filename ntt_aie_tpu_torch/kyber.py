"""ML-KEM (FIPS 203 / Kyber) NTT over Z_3329[X]/(X^256 + 1).

Port of ``ntt_aie_tpu.kyber``: the real ML-KEM arithmetic, batched on the
device.

- ``kyber_ntt``: the 7-layer incomplete NTT (zeta = 17, layers len =
  128..2, zetas in BitRev7 order; FIPS 203 Algorithm 9),
- ``kyber_intt``: its inverse with the 1/128 scale (Algorithm 10),
- ``kyber_basemul``: MultiplyNTTs, 128 products of degree-1 polynomials
  mod (X^2 - zeta^(2 BitRev7(i) + 1)) (Algorithms 11-12),
- ``kyber_polymul``: intt(basemul(ntt(a), ntt(b))), the negacyclic
  product in the ML-KEM ring,
- ``kyber_matvec``: the NTT-domain module-lattice A s (the K-PKE shape),
- ``make_pipeline``: the serving bundle.

On a CUDA tensor each function is one launch of a kernel of
``csrc/ring_layers.cu``: ``kyber_ntt``/``kyber_intt`` the layered
transform (``ops.ring_layers.layered``), ``kyber_basemul``,
``kyber_polymul``, ``kyber_matvec``, ``kyber_serve`` and
``kyber_serving_step`` the fused ring product
(``ops.ring_layers.ring_product``; ``kyber_serving_step`` with one
matrix for the whole batch is two: the matrix's transform, then the
product). On a CPU tensor they run the plain versions:
``ring_layers.layered_fwd``/``layered_inv`` with the reference's Barrett
multiply (``ops.modops.barrett_mul``) and basemul and matvec as torch ops
on int64 carriers. Every function takes (..., 256) values in [0, 3329),
batched or single, and returns an int32 tensor; the device rule is
``ring_layers``'s (a tensor stays on its device, other arrays go to the
card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ntt_aie_tpu_torch import fields as F
from ntt_aie_tpu_torch import ring_layers as RL
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops import ring_layers as LR
from ntt_aie_tpu_torch.twiddles import bit_reverse_indices
from ntt_aie_tpu_torch.utils.device import resolve_device

Q = 3329
ZETA = 17
N = 256
_W, _U = F.KYBER.barrett_w, F.KYBER.barrett_u  # Barrett constants for 3329

_ZETAS = RL.layer_zeta_tables(ZETA, Q, 7, 7)
_IZETAS = RL.layer_zeta_tables(ZETA, Q, 7, 7, inverse=True)
_REV7 = bit_reverse_indices(128)
_GAMMAS = np.array(
    [F.modpow(ZETA, 2 * int(_REV7[i]) + 1, Q) for i in range(128)],
    dtype=np.uint32,
)
_N_INV = F.modpow(128, Q - 2, Q)  # 3303


def _mul(a, b):
    return M.barrett_mul(a, b, Q, _W, _U)


@functools.lru_cache(maxsize=None)
def _gammas(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_GAMMAS.astype(np.int64)).to(device).reshape(
        1, 128)


def _basemul_plain(ahat: torch.Tensor, bhat: torch.Tensor) -> torch.Tensor:
    """MultiplyNTTs in torch ops on int32 tensors on their device (the
    plain version; the result has ahat's shape)."""
    a, b = M.to_carrier(ahat), M.to_carrier(bhat)
    shape = a.shape
    a2, b2 = a.reshape(-1, 128, 2), b.reshape(-1, 128, 2)
    a0, a1 = a2[..., 0], a2[..., 1]
    b0, b1 = b2[..., 0], b2[..., 1]
    g = _gammas(a.device)
    c0 = M.add_mod(_mul(a0, b0), _mul(_mul(a1, b1), g), Q)
    c1 = M.add_mod(_mul(a0, b1), _mul(a1, b0), Q)
    return M.from_carrier(torch.stack((c0, c1), dim=-1).reshape(shape))


def _matvec_plain(ahat: torch.Tensor, shat: torch.Tensor) -> torch.Tensor:
    """The NTT-domain matvec in torch ops (the plain version)."""
    return RL.matvec_terms(
        ahat, shat, _basemul_plain,
        lambda u, v: M.from_carrier(M.add_mod(M.to_carrier(u),
                                              M.to_carrier(v), Q)))


SCHEME = LR.Scheme(name="kyber", q=Q, n=N, zetas=tuple(_ZETAS),
                   izetas=tuple(_IZETAS), scale=_N_INV, mulz=_mul,
                   pointwise_plain=_basemul_plain, matvec_plain=_matvec_plain,
                   product_scale=_N_INV, gammas=tuple(int(g) for g in _GAMMAS))


def kyber_ntt(f) -> torch.Tensor:
    """FIPS 203 Algorithm 9 over the last axis (length 256)."""
    return LR.layered(f, SCHEME)


def kyber_intt(fhat) -> torch.Tensor:
    """FIPS 203 Algorithm 10 (inverse layers in reverse, GS butterflies,
    final 1/128 scale)."""
    return LR.layered(fhat, SCHEME, inverse=True)


def kyber_basemul(ahat, bhat) -> torch.Tensor:
    """MultiplyNTTs (FIPS 203 Algorithms 11-12): pairwise products of
    degree-1 polynomials mod (X^2 - gamma_i). Operands of one shape."""
    return LR.ring_product(ahat, bhat, SCHEME, "pointwise")


def kyber_polymul(a, b) -> torch.Tensor:
    """a * b in Z_3329[X]/(X^256 + 1) via the ML-KEM pipeline:
    intt(basemul(ntt(a), ntt(b)))."""
    return LR.ring_product(a, b, SCHEME, "product")


def kyber_matvec(ahat, shat) -> torch.Tensor:
    """Module-lattice matrix-vector product in the NTT domain, the ML-KEM
    serving primitive (K-PKE encrypt/decrypt, FIPS 203 Algorithms 14-15).
    ahat: (..., k, l, 256), shat: (..., l, 256), both NTT-domain; returns
    (..., k, 256) = sum_j ahat[..., i, j, :] o shat[..., j, :]. Either
    side may carry extra batch dims (one key's A against a batch of
    vectors, or batched A)."""
    return LR.ring_product(shat, ahat, SCHEME, "matvec")


def kyber_serve(ahat, x) -> torch.Tensor:
    """intt(matvec(ahat, ntt(x))): the serving step against an NTT-domain
    matrix (one key's A_hat against a batch of vectors)."""
    return LR.ring_product(x, ahat, SCHEME, "serve")


def kyber_serving_step(A, x) -> torch.Tensor:
    """intt(matvec(ntt(A), ntt(x))): the serving step with a fresh A."""
    return LR.ring_product(x, A, SCHEME, "serve_fresh")


def make_pipeline(device=None) -> dict:
    """The ML-KEM serving bundle on `device` (None: the card, RuntimeError
    without one; ring_layers.make_pipeline): ntt, intt, polymul,
    pointwise (basemul), matvec, serving_step and make_serving_step. The
    ML-KEM-768 serving step is make_pipeline()["make_serving_step"](A_hat)
    with A_hat (k=3, l=3, 256) applied to (B, 3, 256) batches."""
    return RL.make_pipeline(kyber_ntt, kyber_intt, kyber_matvec,
                            kyber_polymul, kyber_basemul, kyber_serve,
                            kyber_serving_step, resolve_device(device))
