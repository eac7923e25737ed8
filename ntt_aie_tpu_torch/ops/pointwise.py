"""The exact 32-bit pointwise product: a CUDA kernel and its plain PyTorch
version.

``mul32(a, b, p)`` is the spectral product every 32-bit ring product runs
between its transforms (``Plan.pointwise``, every ``polymul*``, the n = 2
flat plan's products, the distributed plan's ``pointwise``): per value
(a mod p) * (b mod p) mod p, the canonical product, on ``torch.int32``
tensors holding uint32 bit patterns, in and out. b has a's shape, or a's
trailing shape and is broadcast over a's leading axes (psi over a batch).

The reference computes it under XLA (its jitted ``_pointwise``,
``ntt_aie_tpu/plan.py:175-187``, one fused elementwise kernel); it has no
Pallas kernel. On CUDA tensors ``mul32`` launches ``csrc/pointwise.cu``
(one launch a call, on the current stream of a's card), which refuses
non-contiguous tensors and sizes it does not take with an error: there is
no ``.contiguous()`` and no fallback. On CPU tensors it runs
``mul32_plain``, the plain version: ``Reduction.mul_data``'s body,
``(x % p) * (y % p) % p`` on int64 carriers (``ops.reductions``). Both
give the same bits for any uint32 inputs and every modulus 2 <= p < 2^31.
``mul32.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops.reductions import canonical_product

MAX_P = 1 << 31  # csrc/pointwise.cu: 2p < 2^32 keeps its remainder exact


def _check_operands(a: torch.Tensor, b: torch.Tensor, p: int) -> None:
    """Checks that b has a's shape or its trailing shape, both int32 on
    one device, and 2 <= p < 2^31; ValueError otherwise."""
    if not 2 <= p < MAX_P:
        raise ValueError(f"mul32 takes a modulus 2 <= p < 2^31, got {p}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError(f"mul32 takes int32 tensors of uint32 bits, got "
                         f"{a.dtype} and {b.dtype}")
    if (b.dim() > a.dim() or a.shape[a.dim() - b.dim():] != b.shape
            or a.device != b.device):
        raise ValueError(f"mul32 takes b of a's shape or of its trailing "
                         f"shape, on a's device: got {tuple(a.shape)} on "
                         f"{a.device} and {tuple(b.shape)} on {b.device}")


def mul32_plain(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """The product in plain PyTorch ops on int64 carriers of the uint32
    values, on any device: the oracle the kernel is held against."""
    _check_operands(a, b, p)
    return M.from_carrier(canonical_product(p)(M.to_carrier(a),
                                               M.to_carrier(b)))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(C.build_library("pointwise")))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ntt_mul32.restype = ci
    lib.ntt_mul32.argtypes = [vp, vp, vp, cll, cll, ctypes.c_uint, vp]
    lib.ntt_mul32_vectorized.restype = ci
    lib.ntt_mul32_vectorized.argtypes = [vp, vp, vp, cll, cll]
    lib.ntt_pointwise_error_string.restype = ctypes.c_char_p
    lib.ntt_pointwise_error_string.argtypes = [ci]
    return lib


def vectorized(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the kernel takes these tensors four values a thread (16-byte
    loads and stores), as csrc/pointwise.cu decides; it reads the
    library, so a's card must have one."""
    return bool(_library().ntt_mul32_vectorized(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), b.numel()))


def mul32(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """(a mod p) * (b mod p) mod p, value by value, b broadcast over a's
    leading axes: the kernel for CUDA tensors, the plain version for CPU
    tensors, ValueError on any other device."""
    _check_operands(a, b, p)
    if a.device.type == "cpu":
        return mul32_plain(a, b, p)
    if a.device.type != "cuda":
        raise ValueError(f"no 32-bit pointwise product for device "
                         f"{a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the CUDA pointwise product takes contiguous "
                         "tensors")
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.ntt_mul32(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            a.numel(), b.numel(), p, stream)
    if err != 0:
        raise RuntimeError("CUDA pointwise product launch failed: "
                           + lib.ntt_pointwise_error_string(err).decode())
    mul32.launches += 1
    return out


mul32.launches = 0
