"""CRT recombination of RNS residues into uint32 limbs: a CUDA kernel and
its plain PyTorch version.

Port of ``ntt_aie_tpu/ops/crt.py`` (which the reference runs under XLA):
``make_crt_combine(fields)`` returns ``(fn, nwords)``; fn maps k equally
shaped residue arrays (canonical, [0, p_i), in the order of `fields`) to
one (..., nwords) array of the little-endian uint32 limbs of CRT(r) in
[0, M), or with centered=True of the centered representative in
(-M/2, M/2] encoded two's-complement. ``limbs_to_int`` turns limbs back
into Python ints on the host.

The algorithm is the reference's Garner chain: the primes in ascending
order, so every digit v_j < p_j is already reduced mod any later p_i;
digits by conditional subtracts and Montgomery constant multiplies
against inv(p_j) * R mod p_i; the positional sum v_1 + v_2 p_1 + ... in
uint32 limbs with carries; the centered lift as a multi-word conditional
subtract of M. fn runs the CUDA kernel ``csrc/crt.cu`` on CUDA tensors
and the plain version ``crt_combine_plain`` (torch ops on int64 carriers
of uint32 values, ``ops.modops``) on CPU tensors; there is no fallback.
Both compute the same integers, so their limbs are equal bit for bit.

Tensors are ``torch.int32`` holding uint32 bit patterns, as elsewhere in
the port; fn also takes NumPy arrays, which it moves to its device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch

from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.utils.device import resolve_device

MAX_FIELDS = 8  # csrc/crt.cu kMaxFields
MAX_WORDS = 8   # csrc/crt.cu kMaxWords


def _to_limbs(x: int, nwords: int) -> list:
    """Little-endian uint32 limb decomposition of a nonnegative int."""
    out = []
    for _ in range(nwords):
        out.append(x & 0xFFFFFFFF)
        x >>= 32
    if x:
        raise ValueError("value does not fit in the requested limb count")
    return out


def limbs_to_int(limbs, *, signed: bool = True) -> np.ndarray:
    """Recombine an (..., L) uint32 little-endian limb array into object
    ints (host object math). With signed=True the top limb's MSB is the
    two's-complement sign (the encoding of the centered combine). A torch
    tensor (int32 limbs, on any device) is read back first."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy().view(np.uint32)
    limbs = np.asarray(limbs).astype(np.uint32)
    L = limbs.shape[-1]
    if L == 0:
        return np.zeros(limbs.shape[:-1], dtype=object)
    # uint32 limbs paired into uint64 words with machine math first: half
    # the object-array passes
    l64 = limbs.astype(np.uint64)
    words = [l64[..., i] | (l64[..., i + 1] << np.uint64(32))
             for i in range(0, L - 1, 2)]
    if L % 2:
        words.append(l64[..., L - 1])
    acc = words[-1].astype(object)
    for w in reversed(words[:-1]):
        acc = (acc << 64) + w.astype(object)
    if signed:
        sign_bit = 1 << (32 * L - 1)
        full = 1 << (32 * L)
        acc = np.where(acc >= sign_bit, acc - full, acc)
    return acc


@dataclasses.dataclass(frozen=True, eq=False)
class CrtCombine:
    """One combine's constants, in the chain's ascending-prime order.

    order[a]: the index in `fields` of the chain's a-th prime; primes,
    neg_pinv (-p^-1 mod 2^32) per chain prime; inv_const[a][j] =
    inv(p_j) * 2^32 mod p_a for j < a; weights[a]: the limbs of the
    product of the primes before a; m_limbs, half_limbs: the limbs of M
    and floor(M / 2)."""

    fields: tuple
    order: tuple
    primes: tuple
    neg_pinv: tuple
    inv_const: tuple
    weights: tuple
    m_limbs: tuple
    half_limbs: tuple
    nwords: int
    centered: bool
    device: torch.device

    @property
    def k(self) -> int:
        return len(self.primes)

    def __call__(self, *residues) -> torch.Tensor:
        return crt_combine(residues, self)


def make_crt_combine(fields: Sequence, *, centered: bool = True,
                     device=None):
    """The CRT combine of these residue fields: (fn, nwords), as the
    reference's. fn(*residues) maps k equally shaped residue arrays
    (canonical, in the order of `fields`; tensors, or NumPy arrays moved
    to `device`) to an (..., nwords) int32 tensor of uint32 limbs. Every
    prime must be odd and < 2^31, and the primes pairwise coprime; at most
    MAX_FIELDS primes and MAX_WORDS limbs (the kernel's registers).
    device: None is the card (utils.device.resolve_device)."""
    device = resolve_device(device)
    fields = list(fields)
    k = len(fields)
    if k < 1:
        raise ValueError("need at least one residue field")
    for f in fields:
        if f.p % 2 == 0 or f.p >= (1 << 31):
            raise ValueError(
                f"device CRT needs odd primes < 2^31, got {f.p}")
    for i, f in enumerate(fields):
        for g in fields[i + 1:]:
            if math.gcd(f.p, g.p) != 1:
                raise ValueError(
                    f"CRT moduli must be pairwise coprime; got {f.p} and "
                    f"{g.p} (a shared factor makes the basis degenerate)")
    order = sorted(range(k), key=lambda i: fields[i].p)
    chain = [fields[i] for i in order]
    modulus = math.prod(f.p for f in chain)
    nwords = max(1, -(-modulus.bit_length() // 32))
    if k > MAX_FIELDS or nwords > MAX_WORDS:
        raise ValueError(f"the CRT combine takes at most {MAX_FIELDS} primes "
                         f"and {MAX_WORDS} limbs, got {k} and {nwords}")
    inv_const = tuple(tuple(fi.to_mont(fi.inv(fj.p % fi.p))
                            for fj in chain[:i])
                      for i, fi in enumerate(chain))
    weights, acc = [], 1
    for f in chain:
        weights.append(tuple(_to_limbs(acc, nwords)))
        acc *= f.p
    cc = CrtCombine(
        fields=tuple(fields), order=tuple(order),
        primes=tuple(f.p for f in chain),
        neg_pinv=tuple(f.mont_neg_pinv for f in chain),
        inv_const=inv_const, weights=tuple(weights),
        m_limbs=tuple(_to_limbs(modulus, nwords)),
        half_limbs=tuple(_to_limbs(modulus >> 1, nwords)),
        nwords=nwords, centered=centered, device=device)
    return cc, nwords


def _residue_tensors(residues, cc: CrtCombine) -> list:
    """The residues as int32 tensors of one shape and device (NumPy arrays
    moved to cc.device)."""
    if len(residues) != cc.k:
        raise ValueError(f"expected {cc.k} residue arrays, got "
                         f"{len(residues)}")
    out = []
    for r in residues:
        if not isinstance(r, torch.Tensor):
            r = np.ascontiguousarray(np.asarray(r).astype(np.uint32))
            r = torch.from_numpy(r.view(np.int32)).to(cc.device)
        elif r.dtype != torch.int32:
            r = M.from_carrier(M.to_carrier(r))
        out.append(r)
    if any(r.shape != out[0].shape or r.device != out[0].device
           for r in out):
        raise ValueError("the residues must share one shape and device")
    return out


# ---- plain PyTorch version -------------------------------------------------

def crt_combine_plain(residues, cc: CrtCombine) -> torch.Tensor:
    """The combine in plain PyTorch ops on int64 carriers of uint32 values
    (``ops.modops`` sub_mod, mont_mul, umul32_wide), on any device: the
    oracle the kernel is held against."""
    res = _residue_tensors(residues, cc)
    res = [M.to_carrier(res[i]) for i in cc.order]
    digits = []
    for i, p in enumerate(cc.primes):
        t = res[i]
        for j in range(i):
            t = M.sub_mod(t, digits[j], p)
            t = M.mont_mul(t, torch.full_like(t, cc.inv_const[i][j]), p,
                           cc.neg_pinv[i])
        digits.append(t)
    zero = torch.zeros_like(res[0])
    acc = [zero] * cc.nwords
    for v, wlimbs in zip(digits, cc.weights):
        carry = zero
        for t, w in enumerate(wlimbs):
            hi, lo = M.umul32_wide(v, torch.full_like(v, w))
            s = acc[t] + lo + carry  # < 3 * 2^32
            acc[t] = s & M.MASK32
            carry = hi + (s >> 32)
    if cc.centered:
        gt = torch.zeros_like(zero, dtype=torch.bool)
        eq = torch.ones_like(zero, dtype=torch.bool)
        for t in reversed(range(cc.nwords)):
            h = cc.half_limbs[t]
            gt = gt | (eq & (acc[t] > h))
            eq = eq & (acc[t] == h)
        borrow = zero
        sub = []
        for t in range(cc.nwords):
            d = acc[t] - cc.m_limbs[t] - borrow
            sub.append(d & M.MASK32)
            borrow = (d < 0).to(torch.int64)
        acc = [torch.where(gt, s, a) for s, a in zip(sub, acc)]
    return M.from_carrier(torch.stack(acc, dim=-1))


# ---- CUDA kernel -----------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(C.build_library("crt")))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pu = ctypes.POINTER(ctypes.c_uint)
    lib.ntt_crt_combine.restype = ci
    lib.ntt_crt_combine.argtypes = [ctypes.POINTER(vp), vp, cll, ci, ci, pu,
                                    pu, pu, pu, pu, pu, ci, vp]
    lib.ntt_crt_error_string.restype = ctypes.c_char_p
    lib.ntt_crt_error_string.argtypes = [ci]
    lib.ntt_crt_max_fields.restype = ci
    lib.ntt_crt_max_words.restype = ci
    if (lib.ntt_crt_max_fields(), lib.ntt_crt_max_words()) != (MAX_FIELDS,
                                                               MAX_WORDS):
        raise RuntimeError("csrc/crt.cu kMaxFields/kMaxWords disagree with "
                           "MAX_FIELDS/MAX_WORDS")
    return lib


def _uints(values) -> ctypes.Array:
    values = [int(v) for v in values]
    return (ctypes.c_uint * max(1, len(values)))(*values)


def _launch(res: list, cc: CrtCombine) -> torch.Tensor:
    if not all(r.is_contiguous() for r in res):
        raise ValueError("the CUDA CRT combine takes contiguous tensors")
    out = torch.empty(res[0].shape + (cc.nwords,), dtype=torch.int32,
                      device=res[0].device)
    k = cc.k
    ptrs = (ctypes.c_void_p * k)(*(res[i].data_ptr() for i in cc.order))
    inv = [cc.inv_const[a][j] if j < a else 0
           for a in range(k) for j in range(k)]
    lib = _library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.ntt_crt_combine(
            ptrs, out.data_ptr(), res[0].numel(), k, cc.nwords,
            _uints(cc.primes), _uints(cc.neg_pinv), _uints(inv),
            _uints([w for row in cc.weights for w in row]),
            _uints(cc.m_limbs), _uints(cc.half_limbs), int(cc.centered),
            stream)
    if err != 0:
        raise RuntimeError("CUDA CRT combine launch failed: "
                           + lib.ntt_crt_error_string(err).decode())
    crt_combine.launches += 1
    return out


def crt_combine(residues, cc: CrtCombine) -> torch.Tensor:
    """Run the combine: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. ``crt_combine.launches`` counts kernel launches."""
    res = _residue_tensors(residues, cc)
    device = res[0].device
    if device.type == "cpu":
        return crt_combine_plain(res, cc)
    if device.type != "cuda":
        raise ValueError(f"no CRT combine for device {device}")
    if res[0].numel() == 0:
        return torch.empty(res[0].shape + (cc.nwords,), dtype=torch.int32,
                           device=device)
    return _launch(res, cc)


crt_combine.launches = 0
