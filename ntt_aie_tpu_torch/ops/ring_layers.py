"""The FIPS 203/204 layered transforms: a CUDA kernel and its plain
PyTorch version.

The reference runs ``ring_layers.layered_fwd``/``layered_inv`` (with the
inverse's final scale in ``kyber_intt``/``dilithium_intt``) under XLA
(``ntt_aie_tpu/ring_layers.py:49-79``); the port runs one launch of
``csrc/ring_layers.cu`` a transform on CUDA tensors and the plain version
(``ring_layers.layered_fwd``/``layered_inv`` on int64 carriers) on CPU
tensors; there is no fallback. A ``Scheme`` holds one ring's constants
and tables (``kyber.SCHEME``, ``dilithium.SCHEME``); ``layered(f, scheme,
inverse=)`` runs its forward or inverse transform over the last axis of
(..., 256) values, canonical in [0, q), and returns an int32 tensor of
the same shape. Both routes compute exact canonical values, so they are
equal bit for bit.

``layered.launches`` counts kernel launches, ``layered.launches_by``
them by instantiation (``"kyber_ntt"``, ``"kyber_intt"``,
``"dilithium_ntt"``, ``"dilithium_intt"``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from ntt_aie_tpu_torch import ring_layers as RL
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import modops as M

# the kernels' scheme index (csrc/ring_layers.cu pick_kernel)
KERNEL_SCHEMES = {"kyber": 0, "dilithium": 1}


@dataclasses.dataclass(frozen=True, eq=False)
class Scheme:
    """One ring's layered transform: name ('kyber' or 'dilithium'), q, n
    (256), the per-layer zeta and inverse-zeta tables in table form
    (ring_layers.layer_zeta_tables), the inverse's final multiplier in the
    same form, mulz(v, z) -> v * z mod q on carriers against a table-form
    z (canonical), and neg_pinv (-q^-1 mod 2^32 where mulz is Montgomery's,
    else 0: the kernel's check)."""

    name: str
    q: int
    n: int
    zetas: tuple
    izetas: tuple
    scale: int
    mulz: Callable
    neg_pinv: int = 0

    @property
    def n_layers(self) -> int:
        return len(self.zetas)

    def flat_table(self, inverse: bool) -> np.ndarray:
        """The kernel's table: entry 2^L + b is layer L's block b (the
        standards' index k; entry 0 unused)."""
        out = np.zeros(1 << self.n_layers, dtype=np.uint32)
        for L, z in enumerate(self.izetas if inverse else self.zetas):
            out[1 << L: 2 << L] = z
        return out


@functools.lru_cache(maxsize=None)
def tables(scheme: Scheme, device: torch.device) -> dict:
    """The scheme's tables on `device`: per-layer carriers (zetas,
    izetas), the scale as a (1, 1) carrier, and the kernel's flat int32
    tables (flat, iflat)."""

    def carrier(v):
        return torch.from_numpy(np.asarray(v).astype(np.int64)).to(device)

    def flat(inverse):
        return torch.from_numpy(
            scheme.flat_table(inverse).view(np.int32)).to(device)

    return {"zetas": [carrier(z) for z in scheme.zetas],
            "izetas": [carrier(z) for z in scheme.izetas],
            "scale": carrier([[scheme.scale]]),
            "flat": flat(False), "iflat": flat(True)}


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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(C.build_library("ring_layers")))
    vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.ntt_ring_layers.restype = ci
    lib.ntt_ring_layers.argtypes = [ci, ci, vp, vp, ctypes.c_longlong, vp,
                                    cu, vp]
    lib.ntt_ring_layers_error_string.restype = ctypes.c_char_p
    lib.ntt_ring_layers_error_string.argtypes = [ci]
    lib.ntt_ring_layers_info.restype = ci
    lib.ntt_ring_layers_info.argtypes = [ci, ctypes.POINTER(cu),
                                         ctypes.POINTER(ci),
                                         ctypes.POINTER(cu)]
    return lib


@functools.cache
def check_constants(scheme: Scheme) -> None:
    """Raise if the kernel was compiled with other constants than the
    scheme's (q, layer count, -q^-1 mod 2^32); once a scheme."""
    q, layers, neg_pinv = ctypes.c_uint(), ctypes.c_int(), ctypes.c_uint()
    if _library().ntt_ring_layers_info(
            KERNEL_SCHEMES[scheme.name], ctypes.byref(q), ctypes.byref(layers),
            ctypes.byref(neg_pinv)) != 0:
        raise RuntimeError(f"csrc/ring_layers.cu has no scheme {scheme.name}")
    got = (q.value, layers.value, neg_pinv.value)
    if got != (scheme.q, scheme.n_layers, scheme.neg_pinv):
        raise RuntimeError(f"csrc/ring_layers.cu's {scheme.name} constants "
                           f"{got} disagree with the scheme's")


def _launch(x: torch.Tensor, scheme: Scheme, inverse: bool) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // scheme.n
    if rows == 0:
        return out
    check_constants(scheme)
    flat = tables(scheme, x.device)["iflat" if inverse else "flat"]
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ntt_ring_layers(KERNEL_SCHEMES[scheme.name], int(inverse),
                                  x.data_ptr(), out.data_ptr(), rows,
                                  flat.data_ptr(), scheme.scale, stream)
    if err != 0:
        raise RuntimeError("CUDA ring-layers launch failed: "
                           + lib.ntt_ring_layers_error_string(err).decode())
    key = f"{scheme.name}_{'intt' if inverse else 'ntt'}"
    layered.launches += 1
    layered.launches_by[key] = layered.launches_by.get(key, 0) + 1
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
