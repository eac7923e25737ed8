"""Shared layered-NTT machinery of the FIPS 203/204 ring modules.

Port of ``ntt_aie_tpu.ring_layers``. ML-KEM (``kyber.py``, 7 layers,
Barrett) and ML-DSA (``dilithium.py``, 8 layers, Montgomery) run the same
CT/GS layer structure over Z_q[X]/(X^256 + 1); only the layer count, the
zeta tables and the modular multiply differ.

``layered_fwd``/``layered_inv`` are the transforms in plain PyTorch ops,
the plain version of the CUDA kernel ``csrc/ring_layers.cu``
(``ops.ring_layers``, which the scheme modules call). The reference lays a
batch out as (n, B) matrices, coefficients on the TPU's sublanes and the
batch on its lanes; the port keeps the caller's (..., 256) rows, one
polynomial a row, and never transposes.

Values are int64 carriers of uint32 values (``ops.modops``) inside, and
int32 tensors holding values in [0, q) at the modules' public functions.
Device rule of those functions: a tensor argument stays on its own
device (a CPU tensor is the caller asking for the plain route); an
argument that is not a tensor goes to the device of the call's tensor
arguments, or with none to ``utils.device.resolve_device(None)``, the
card. ``make_pipeline`` holds its callables on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from ntt_aie_tpu_torch import fields as F
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.twiddles import bit_reverse_indices
from ntt_aie_tpu_torch.utils.device import resolve_device


def layer_zeta_tables(zeta: int, q: int, n_layers: int, rev_bits: int,
                      inverse: bool = False, post=int) -> list[np.ndarray]:
    """Per-layer per-block zeta vectors. Layer L has 2^L blocks; the
    standards' sequential index k gives block i of layer L the value
    zeta^BitRev(2^L + i) with BitRev over ``rev_bits`` bits (BitRev7 for
    ML-KEM, BitRev8 for ML-DSA). ``post`` maps each scalar into the table
    representation (e.g. Montgomery form)."""
    rev = bit_reverse_indices(1 << rev_bits)
    layers = []
    for L in range(n_layers):
        blocks = 1 << L
        vals = [F.modpow(zeta, int(rev[blocks + i]), q) for i in range(blocks)]
        if inverse:
            vals = [F.modpow(v, q - 2, q) for v in vals]
        layers.append(np.array([post(v) for v in vals], dtype=np.uint32))
    return layers


def operand_device(*args) -> torch.device:
    """The device of a call: that of its first tensor argument, else the
    card (resolve_device(None))."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(None)


def as_i32(f, device) -> torch.Tensor:
    """An array-like of values in [0, 2^31) as an int32 tensor on
    `device` (a tensor already there is returned as it is, or cast)."""
    if isinstance(f, torch.Tensor):
        return f.to(device=device, dtype=torch.int32)
    return torch.from_numpy(np.asarray(f).astype(np.int64)).to(
        device=device, dtype=torch.int32)


def layered_fwd(x: torch.Tensor, layer_zetas, mulz, q: int) -> torch.Tensor:
    """CT butterfly layers over (rows, n) carriers: layer L splits each
    row into 2^L blocks of half-length (n/2) >> L; (u, v) -> (u + z*v,
    u - z*v). layer_zetas: one (2^L,) carrier a layer, on x's device;
    mulz(v, z): v * z mod q, canonical."""
    rows, n = x.shape
    for L, ztab in enumerate(layer_zetas):
        len_, blocks = (n // 2) >> L, 1 << L
        xr = x.reshape(rows, blocks, 2, len_)
        u, v = xr[:, :, 0], xr[:, :, 1]
        t = mulz(v, ztab.reshape(blocks, 1))
        x = torch.stack((M.add_mod(u, t, q), M.sub_mod(u, t, q)),
                        dim=2).reshape(rows, n)
    return x


def layered_inv(x: torch.Tensor, layer_izetas, mulz, q: int) -> torch.Tensor:
    """GS butterfly layers in reverse order: (u, v) -> (u + v,
    z^-1 * (u - v)). The caller applies the final 1/n-ish scale."""
    rows, n = x.shape
    for L in reversed(range(len(layer_izetas))):
        len_, blocks = (n // 2) >> L, 1 << L
        xr = x.reshape(rows, blocks, 2, len_)
        u, v = xr[:, :, 0], xr[:, :, 1]
        z = layer_izetas[L].reshape(blocks, 1)
        x = torch.stack((M.add_mod(u, v, q), mulz(M.sub_mod(u, v, q), z)),
                        dim=2).reshape(rows, n)
    return x


def matvec_terms(ahat: torch.Tensor, xhat: torch.Tensor, pointwise,
                 add_mod_q) -> torch.Tensor:
    """sum_j pointwise(ahat[..., :, j, :], xhat[..., j, :]): the
    module-lattice matvec skeleton. Broadcasts the vector against the
    matrix rows; either side may carry extra batch dims (a shared (k, l,
    256) matrix against (B, l, 256) vectors, or batched matrices)."""
    l = ahat.shape[-2]

    def term(j):
        aj = ahat[..., :, j, :]
        xj = xhat[..., None, j, :]
        shape = torch.broadcast_shapes(aj.shape, xj.shape)
        return pointwise(aj.expand(shape), xj.expand(shape))

    acc = term(0)
    for j in range(1, l):
        acc = add_mod_q(acc, term(j))
    return acc


def make_pipeline(ntt, intt, matvec, polymul, pointwise, serve,
                  serving_step, device) -> dict:
    """The serving-pipeline bundle on `device`, the twin of the
    reference's ``jit_pipeline`` (its ring_layers.py:82-115) with the
    same keys; no jit: plain callables whose operands go to the device
    (a tensor elsewhere is moved there). On the card each callable is
    one kernel launch (serving_step with one matrix for the batch two),
    as each of the reference's is one compiled program.

      ntt / intt / polymul / pointwise / matvec: the module functions;
      serving_step(A, x): intt(matvec(ntt(A), ntt(x))), a fresh A a call;
      make_serving_step(A_hat): A_hat moved to the device once; returns
        x -> serve(A_hat, x) = intt(matvec(A_hat, ntt(x))) (the serving
        shape: one key's A against a batch of vectors).
    """

    def on_device(fn):
        return lambda *args: fn(*(as_i32(a, device) for a in args))

    def make_serving_step(A_hat):
        A_hat = as_i32(A_hat, device)
        return lambda x: serve(A_hat, as_i32(x, device))

    return {
        "ntt": on_device(ntt),
        "intt": on_device(intt),
        "polymul": on_device(polymul),
        "pointwise": on_device(pointwise),
        "matvec": on_device(matvec),
        "serving_step": on_device(serving_step),
        "make_serving_step": make_serving_step,
    }
