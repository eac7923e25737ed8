"""The FIPS 203/204 layered transforms and fused ring products: CUDA
kernels and their plain PyTorch versions.

The reference runs ``ring_layers.layered_fwd``/``layered_inv`` (with the
inverse's final scale in ``kyber_intt``/``dilithium_intt``) and the
products and matvec around them under XLA, one jitted program a pipeline
callable (``ntt_aie_tpu/ring_layers.py:49-115``). The port runs one launch
of ``csrc/ring_layers.cu`` a call on CUDA tensors and the plain versions on
CPU tensors; there is no fallback. A ``Scheme`` holds one ring's constants,
tables and plain products (``kyber.SCHEME``, ``dilithium.SCHEME``).

- ``layered(f, scheme, inverse=)``: the forward or inverse transform over
  the last axis of (..., 256) values; plain version ``layered_plain``.
- ``ring_product(x, a, scheme, mode)``: ``[intt](sum_j a o [ntt] x)`` in
  one launch, the stages switched by ``mode`` (``MODES``): ``"product"``
  (polymul), ``"pointwise"`` (basemul / pointwise), ``"matvec"``,
  ``"serve"`` (``intt(matvec(A_hat, ntt(x)))``) and ``"serve_fresh"``
  (``intt(matvec(ntt(A), ntt(x)))``); plain version ``ring_product_plain``.

Values are canonical, in [0, q), and every function returns an int32
tensor; both routes compute exact canonical values, so they are equal bit
for bit.

``layered.launches`` counts the launches of every kernel of the source,
``layered.launches_by`` them by instantiation: ``"<scheme>_ntt"``,
``"<scheme>_intt"`` and ``"<scheme>_<mode>"`` (``product``,
``pointwise``, ``matvec``, ``matvec_batched``, ``serve``,
``serve_batched``, ``serve_fresh``; ``_batched``: a matrix a batch row).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ntt_aie_tpu_torch import ring_layers as RL
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import modops as M

# the kernels' scheme index (csrc/ring_layers.cu pick_kernel)
KERNEL_SCHEMES = {"kyber": 0, "dilithium": 1}
# ring_product's modes: name -> (transform x, transform a, inverse-transform
# the result, a is a (..., k, l, 256) matrix and x (..., l, 256) vectors)
MODES = {"product": (True, True, True, False),
         "pointwise": (False, False, False, False),
         "matvec": (False, False, False, True),
         "serve": (True, False, True, True),
         "serve_fresh": (True, True, True, True)}
# the kernel's mode bits (csrc/ring_layers.cu ntt_ring_product)
_FWD_X, _FWD_A, _INV, _SHARED = 1, 2, 4, 8
MAX_RANK = 8  # csrc/ring_layers.cu kMaxRank: the largest k and l


@dataclasses.dataclass(frozen=True, eq=False)
class Scheme:
    """One ring: name ('kyber' or 'dilithium'), q, n (256), the per-layer
    zeta and inverse-zeta tables in table form
    (ring_layers.layer_zeta_tables), the inverse's final multiplier in the
    same form, mulz(v, z) -> v * z mod q on carriers against a table-form
    z (canonical), neg_pinv (-q^-1 mod 2^32 where mulz is Montgomery's,
    else 0: the kernel's check), the plain NTT-domain product
    pointwise_plain(a, b) and matvec_plain(A, x) on int32 tensors, ML-KEM's
    basemul gammas, and the fused kernel's two multipliers: product_scale,
    the inverse's after a product (ML-DSA: n^-1 R^2 in Montgomery form,
    which takes back the products' R^-1), and fixup, the product's without
    an inverse (ML-DSA: R^2 mod q; 0 where the product needs none)."""

    name: str
    q: int
    n: int
    zetas: tuple
    izetas: tuple
    scale: int
    mulz: Callable
    pointwise_plain: Callable
    matvec_plain: Callable
    product_scale: int
    fixup: int = 0
    gammas: tuple = ()
    neg_pinv: int = 0

    @property
    def n_layers(self) -> int:
        return len(self.zetas)

    def flat_table(self, inverse: bool) -> np.ndarray:
        """The transform kernel's table: entry 2^L + b is layer L's block
        b (the standards' index k; entry 0 unused)."""
        out = np.zeros(1 << self.n_layers, dtype=np.uint32)
        for L, z in enumerate(self.izetas if inverse else self.zetas):
            out[1 << L: 2 << L] = z
        return out

    def product_table(self) -> np.ndarray:
        """The fused kernel's table: the forward flat table, the inverse's,
        then the gammas (ML-KEM: entry 2^(layers+1) + i is gamma_i)."""
        return np.concatenate([self.flat_table(False), self.flat_table(True),
                               np.asarray(self.gammas, dtype=np.uint32)])


@functools.lru_cache(maxsize=None)
def tables(scheme: Scheme, device: torch.device) -> dict:
    """The scheme's tables on `device`: per-layer carriers (zetas,
    izetas), the scale as a (1, 1) carrier, and the kernels' flat int32
    tables (flat, iflat, product)."""

    def carrier(v):
        return torch.from_numpy(np.asarray(v).astype(np.int64)).to(device)

    def words(v):
        return torch.from_numpy(v.view(np.int32)).to(device)

    return {"zetas": [carrier(z) for z in scheme.zetas],
            "izetas": [carrier(z) for z in scheme.izetas],
            "scale": carrier([[scheme.scale]]),
            "flat": words(scheme.flat_table(False)),
            "iflat": words(scheme.flat_table(True)),
            "product": words(scheme.product_table())}


def layered_plain(x: torch.Tensor, scheme: Scheme, *,
                  inverse: bool = False) -> torch.Tensor:
    """The transform in plain PyTorch ops (ring_layers.layered_fwd, or
    layered_inv and the final scale) on x's device: the oracle the kernel
    is held against. x: (..., n) int32."""
    t = tables(scheme, x.device)
    rows = M.to_carrier(x.reshape(-1, scheme.n))
    if inverse:
        y = scheme.mulz(RL.layered_inv(rows, t["izetas"], scheme.mulz,
                                       scheme.q), t["scale"])
    else:
        y = RL.layered_fwd(rows, t["zetas"], scheme.mulz, scheme.q)
    return M.from_carrier(y).reshape(x.shape)


def ring_product_plain(x: torch.Tensor, a: torch.Tensor, scheme: Scheme,
                       mode: str) -> torch.Tensor:
    """The fused product in plain PyTorch ops on x's device, the
    composition the pipelines ran before the kernel: layered_plain of x
    and of a where the mode transforms them, the scheme's pointwise_plain
    (x, a) or matvec_plain(a, x), layered_plain's inverse where the mode
    has it. int32 tensors with the module functions' broadcasting."""
    fwd_x, fwd_a, inv, matrix = MODES[mode]
    if fwd_x:
        x = layered_plain(x, scheme)
    if fwd_a:
        a = layered_plain(a, scheme)
    y = scheme.matvec_plain(a, x) if matrix else scheme.pointwise_plain(x, a)
    return layered_plain(y, scheme, inverse=True) if inv else y


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(C.build_library("ring_layers")))
    vp, ci, cu, cl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                      ctypes.c_longlong)
    lib.ntt_ring_layers.restype = ci
    lib.ntt_ring_layers.argtypes = [ci, ci, vp, vp, cl, vp, cu, vp]
    lib.ntt_ring_product.restype = ci
    lib.ntt_ring_product.argtypes = [ci, ci, vp, vp, vp, cl, ci, ci, vp, cu,
                                     vp]
    lib.ntt_ring_product_table_words.restype = ci
    lib.ntt_ring_product_table_words.argtypes = [ci]
    lib.ntt_ring_layers_error_string.restype = ctypes.c_char_p
    lib.ntt_ring_layers_error_string.argtypes = [ci]
    lib.ntt_ring_layers_info.restype = ci
    lib.ntt_ring_layers_info.argtypes = [ci, ctypes.POINTER(cu),
                                         ctypes.POINTER(ci),
                                         ctypes.POINTER(cu)]
    return lib


@functools.cache
def check_constants(scheme: Scheme) -> None:
    """Raise if the kernels were compiled with other constants than the
    scheme's (q, layer count, -q^-1 mod 2^32, the product table's
    length); once a scheme."""
    lib = _library()
    index = KERNEL_SCHEMES[scheme.name]
    q, layers, neg_pinv = ctypes.c_uint(), ctypes.c_int(), ctypes.c_uint()
    if lib.ntt_ring_layers_info(index, ctypes.byref(q), ctypes.byref(layers),
                                ctypes.byref(neg_pinv)) != 0:
        raise RuntimeError(f"csrc/ring_layers.cu has no scheme {scheme.name}")
    got = (q.value, layers.value, neg_pinv.value,
           lib.ntt_ring_product_table_words(index))
    if got != (scheme.q, scheme.n_layers, scheme.neg_pinv,
               len(scheme.product_table())):
        raise RuntimeError(f"csrc/ring_layers.cu's {scheme.name} constants "
                           f"{got} disagree with the scheme's")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous at a 16-byte aligned address (the kernels' vector
    loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _count(key: str) -> None:
    layered.launches += 1
    layered.launches_by[key] = layered.launches_by.get(key, 0) + 1


def _check(err: int) -> None:
    if err != 0:
        raise RuntimeError("CUDA ring-layers launch failed: "
                           + _library().ntt_ring_layers_error_string(err)
                           .decode())


def _launch(x: torch.Tensor, scheme: Scheme, inverse: bool) -> torch.Tensor:
    x = _aligned(x)
    out = torch.empty_like(x)
    rows = x.numel() // scheme.n
    if rows == 0:
        return out
    check_constants(scheme)
    flat = tables(scheme, x.device)["iflat" if inverse else "flat"]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check(_library().ntt_ring_layers(
            KERNEL_SCHEMES[scheme.name], int(inverse), x.data_ptr(),
            out.data_ptr(), rows, flat.data_ptr(), scheme.scale, stream))
    _count(f"{scheme.name}_{'intt' if inverse else 'ntt'}")
    return out


def layered(f, scheme: Scheme, *, inverse: bool = False) -> torch.Tensor:
    """The scheme's forward (inverse=False) or inverse transform over the
    last axis of f, (..., n) canonical values: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor; an array that is not a
    tensor goes to the card (ring_layers.operand_device). Returns an
    int32 tensor of f's shape."""
    x = RL.as_i32(f, RL.operand_device(f))
    if x.shape[-1] != scheme.n:
        raise ValueError(f"the {scheme.name} transform takes (..., "
                         f"{scheme.n}) values, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return layered_plain(x, scheme, inverse=inverse)
    if x.device.type != "cuda":
        raise ValueError(f"no {scheme.name} transform for device {x.device}")
    return _launch(x, scheme, inverse)


layered.launches = 0
layered.launches_by = {}


class ProductOperands(NamedTuple):
    """A ring product in the kernel's batched form: x (B, l, n), a
    (k, l, n) shared by the batch or (B, k, l, n), the result (B, k, n)
    reshaped to out_shape."""

    x: torch.Tensor
    a: torch.Tensor
    shared: bool
    k: int
    l: int
    out_shape: tuple


def _broadcast(s: tuple, t: tuple) -> tuple:
    """The broadcast of two shapes by NumPy's rule (torch.broadcast_shapes
    without its host cost); ValueError where they do not broadcast."""
    s, t = tuple(s), tuple(t)
    if s == t or not t:
        return s
    if not s:
        return t
    ndim = max(len(s), len(t))
    out = []
    for dims in zip((1,) * (ndim - len(s)) + s, (1,) * (ndim - len(t)) + t):
        sizes = {d for d in dims if d != 1}
        if len(sizes) > 1:
            raise ValueError(f"shapes {s} and {t} do not broadcast")
        out.append(sizes.pop() if sizes else 1)
    return tuple(out)


def _batched(t: torch.Tensor, shape: tuple, tail: tuple) -> torch.Tensor:
    """t expanded to shape and viewed (or, expanded, copied) as
    (-1,) + tail."""
    if tuple(t.shape) != shape:
        t = t.expand(shape)
    return t.reshape((-1,) + tail)


def product_operands(x: torch.Tensor, a: torch.Tensor, n: int,
                     matrix: bool) -> ProductOperands:
    """The operands of ring_product in the kernel's batched form, expanded
    on the host where the call broadcasts: vectors x (..., n) and a (...,
    n) to their broadcast shape as k = l = 1; a matrix a (..., k, l, n)
    against vectors x (..., l, n) over their broadcast batch shape, a kept
    shared where its batch shape holds one matrix."""
    if not matrix:
        shape = _broadcast(x.shape, a.shape)
        if shape[-1] != n:
            raise ValueError(f"ring products take (..., {n}) values, got "
                             f"{tuple(x.shape)} and {tuple(a.shape)}")
        return ProductOperands(_batched(x, shape, (1, n)),
                               _batched(a, shape, (1, 1, n)), False, 1, 1,
                               shape)
    if a.dim() < 3 or x.dim() < 2 or a.shape[-1] != n or x.shape[-1] != n \
            or a.shape[-2] != x.shape[-2]:
        raise ValueError(f"a matvec takes (..., k, l, {n}) and (..., l, "
                         f"{n}), got {tuple(a.shape)} and {tuple(x.shape)}")
    k, l = a.shape[-3], a.shape[-2]
    batch = _broadcast(a.shape[:-3], x.shape[:-2])
    xb = _batched(x, batch + (l, n), (l, n))
    shared = math.prod(a.shape[:-3]) == 1
    ab = (a.reshape(k, l, n) if shared
          else _batched(a, batch + (k, l, n), (k, l, n)))
    return ProductOperands(xb, ab, shared, k, l, batch + (k, n))


def _product_launch(x: torch.Tensor, a: torch.Tensor, scheme: Scheme,
                    mode: str) -> torch.Tensor:
    fwd_x, fwd_a, inv, matrix = MODES[mode]
    ops = product_operands(x, a, scheme.n, matrix)
    if not (1 <= ops.k <= MAX_RANK and 1 <= ops.l <= MAX_RANK):
        raise ValueError(f"the ring-product kernel takes k, l <= {MAX_RANK}, "
                         f"got {ops.k} x {ops.l}")
    xb, ab = ops.x, ops.a
    if fwd_a and ops.shared:  # one matrix: transformed once, not a row
        ab, fwd_a, mode = layered(ab, scheme), False, "serve"
    out = torch.empty(ops.out_shape, dtype=torch.int32, device=x.device)
    batch = xb.shape[0]
    if batch == 0:
        return out
    check_constants(scheme)
    xb, ab = _aligned(xb), _aligned(ab)
    bits = (_FWD_X * fwd_x | _FWD_A * fwd_a | _INV * inv
            | _SHARED * ops.shared)
    scale = scheme.product_scale if inv else scheme.fixup
    table = tables(scheme, x.device)["product"]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check(_library().ntt_ring_product(
            KERNEL_SCHEMES[scheme.name], bits, xb.data_ptr(), ab.data_ptr(),
            out.data_ptr(), batch, ops.k, ops.l, table.data_ptr(), scale,
            stream))
    batched = matrix and not ops.shared and mode != "serve_fresh"
    _count(f"{scheme.name}_{mode}{'_batched' * batched}")
    return out


def ring_product(x, a, scheme: Scheme, mode: str) -> torch.Tensor:
    """The fused ring product of `mode` (MODES) on x's and a's device: the
    CUDA kernel for CUDA tensors, ring_product_plain for CPU tensors; an
    array that is not a tensor goes to the device of the call's tensors,
    or to the card (ring_layers.operand_device). Vectors: x and a (...,
    n); a matrix: a (..., k, l, n) and x (..., l, n). The kernel takes
    k, l <= MAX_RANK; a serve_fresh call with one matrix is two launches
    (the matrix's transform, then serve). Returns an int32 tensor."""
    if mode not in MODES:
        raise ValueError(f"ring_product mode {mode!r}: one of {list(MODES)}")
    dev = RL.operand_device(x, a)
    x, a = RL.as_i32(x, dev), RL.as_i32(a, dev)
    if dev.type == "cpu":
        return ring_product_plain(x, a, scheme, mode)
    if dev.type != "cuda":
        raise ValueError(f"no {scheme.name} ring product for device {dev}")
    return _product_launch(x, a, scheme, mode)
