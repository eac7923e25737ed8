"""The fused four-step transform: a CUDA kernel and its plain PyTorch
version.

Port of ``ntt_aie_tpu/ops/pallas_ntt.py`` ``build_fused_fourstep`` /
``make_fused_fourstep``: both four-step passes of one transform in one
kernel, under any ``Reduction`` (harvey4, harvey, montgomery, barrett:
the kernel's library of that kind). Over an (nn_a, nn_b) matrix per batch
row:

    forward: [pre *] DIF over nn_a -> transpose -> * wmid -> DIF over nn_b
             -> [post *] -> canonicalize,          (nn_a, nn_b) = (n1, n2)
    inverse: the DIT mirror with the inverse twiddles, (nn_a, nn_b) = (n2, n1).

``wmid`` is the four-step twiddle matrix and ``post`` a second matrix, both
(nn_b, nn_a), in output orientation; ``pre`` is (nn_a, nn_b), in input
orientation. Each side's own column network (``net_a``, ``net_b``: column
passes with no store options) carries its own nested mid vector, which
``ColPass`` calls ``wmid`` too; the four-step matrix is
``FusedFourstep.wmid``.

``fused_fourstep(x, ff)`` is the entry point. On a CPU tensor it runs the
plain version, ``fused_fourstep_plain``; on a CUDA tensor it launches the
kernel in ``csrc/fused_fourstep.cu`` or raises — there is no fallback, no
switch to two launches. Tensors are ``torch.int32`` holding uint32 bit
patterns: (B, nn_a, nn_b) in, (B, nn_b, nn_a) canonical out; a 2-D input
is a batch of one. The kernel takes its tiles from two counters and
resets them itself (phase A's is zero after every launch, phase B's is
zeroed before phase B), so two launches that overlap must not share them:
``FusedFourstep.counters`` keeps one pair per CUDA stream, and launches on
one stream run one after another.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops.reductions import Reduction
from ntt_aie_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class FusedFourstep:
    """One fused transform: its two column networks and its elementwise
    operands, prepared once on the plan's device as int32 tensors.

    wmid: (2, nn_b, nn_a) four-step twiddle matrix in the reduction's pair
      form (``Reduction.pair``), as pre and post are.
    pre: (2, nn_a, nn_b) multiply before side a, or None.
    post: (2, nn_b, nn_a) multiply after side b, or None.
    streams: the kernel's tile counters, one (2,) int32 pair per CUDA
      stream handle (``counters``).
    """

    red: Reduction
    inverse: bool
    net_a: C.ColPass
    net_b: C.ColPass
    wmid: torch.Tensor
    pre: torch.Tensor | None
    post: torch.Tensor | None
    streams: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape_in(self) -> tuple:
        return (self.net_a.nn, self.net_b.nn)

    def counters(self, stream: int) -> torch.Tensor:
        """The tile counters of phases A and B for launches on the stream
        with this handle: made zero on the plan's device at the first call
        (on the current stream, so before any launch that uses them). Each
        launch leaves phase A's at zero and zeroes phase B's before it takes
        a phase-B tile."""
        pair = self.streams.get(stream)
        if pair is None:
            pair = self.streams.setdefault(
                stream, torch.zeros(2, dtype=torch.int32,
                                    device=self.wmid.device))
        return pair

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return fused_fourstep(x, self)


def make_fused_fourstep(field, n1: int, n2: int, *, inverse: bool = False,
                        wmid: np.ndarray, pre: np.ndarray | None = None,
                        post: np.ndarray | None = None,
                        reduction: str = "harvey4",
                        device=None) -> FusedFourstep:
    """Build a fused transform of an n = n1 * n2 four-step split from the
    port's own twiddles.col_network, under the reduction of this kind.
    wmid / post: host (nn_b, nn_a) matrices; pre: host (nn_a, nn_b);
    (nn_a, nn_b) = (n1, n2) forward, (n2, n1) inverse. device: None is the
    card."""
    device = resolve_device(device)
    direction = "dit" if inverse else "dif"
    nn_a, nn_b = (n2, n1) if inverse else (n1, n2)
    net_a, net_b = (C.make_colpass(field, nn, direction=direction,
                                   inverse_tw=inverse, reduction=reduction,
                                   device=device)
                    for nn in (nn_a, nn_b))
    red = net_a.red

    def operand(m, shape, name):
        if m is None:
            return None
        m = np.asarray(m)
        if m.shape != shape:
            raise ValueError(f"{name} is {m.shape}, expected {shape}")
        return C._pair(*red.pair(m), device)

    return FusedFourstep(red=red, inverse=inverse, net_a=net_a, net_b=net_b,
                         wmid=operand(wmid, (nn_b, nn_a), "wmid"),
                         pre=operand(pre, (nn_a, nn_b), "pre"),
                         post=operand(post, (nn_b, nn_a), "post"))


def _batched(x: torch.Tensor, ff: FusedFourstep):
    if x.dtype != torch.int32:
        raise TypeError(f"fused_fourstep takes int32 tensors, got {x.dtype}")
    squeeze = x.dim() == 2
    xb = x.unsqueeze(0) if squeeze else x
    if xb.dim() != 3 or tuple(xb.shape[1:]) != ff.shape_in:
        raise ValueError(f"this fused transform takes (B, {ff.shape_in[0]}, "
                         f"{ff.shape_in[1]}) or {ff.shape_in}, got "
                         f"{tuple(x.shape)}")
    return xb, squeeze


def fused_fourstep_plain(x: torch.Tensor, ff: FusedFourstep) -> torch.Tensor:
    """The fused transform in plain PyTorch ops (int64 carriers), on any
    device: the CPU route and the oracle the kernel is held against."""
    xb, squeeze = _batched(x, ff)
    red = ff.red

    def mul(v, t):
        if t is None:
            return v
        return red.mulc_mat(v, M.to_carrier(t[0]), M.to_carrier(t[1]))

    v = mul(M.to_carrier(xb), ff.pre)
    v = C.run_network(v, ff.net_a)
    v = mul(v.transpose(1, 2).contiguous(), ff.wmid)
    v = mul(C.run_network(v, ff.net_b), ff.post)
    out = M.from_carrier(red.canonicalize(v)).contiguous()
    return out[0] if squeeze else out


# ---- CUDA kernel -----------------------------------------------------------

def fused_shape_check(nn_a: int, nn_b: int, batch: int) -> tuple:
    """The H100 route's limits, checked before a launch: each side a power
    of two of at most colpass.MAX_ROWS rows (one column tile in an H100
    block's 227 KB of shared memory, colpass.tile_cols' rules), and at most
    2^30 tiles a phase. Returns the tile widths (TL_a, TL_b) of phases A
    and B; raises ValueError above the limits."""
    if batch < 1:
        raise ValueError(f"batch must be at least 1, got {batch}")
    try:
        tl_a, tl_b = C.tile_cols(nn_a, nn_b), C.tile_cols(nn_b, nn_a)
    except ValueError as e:
        raise ValueError(
            f"the fused four-step kernel does not take ({nn_a}, {nn_b}): "
            f"each side must be a power of two of at most {C.MAX_ROWS} rows "
            f"on an H100 ({e})") from None
    if batch * max(nn_b // tl_a, nn_a // tl_b) > (1 << 30):
        raise ValueError(f"the fused four-step kernel takes at most 2^30 "
                         f"tiles a phase; batch {batch} of ({nn_a}, {nn_b}) "
                         "is more")
    return tl_a, tl_b


@functools.cache
def _library(reduction: str = "harvey4") -> ctypes.CDLL:
    lib = ctypes.CDLL(str(C.build_library("fused_fourstep", reduction)))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    pi = ctypes.POINTER(ctypes.c_int)
    side = [ci, ci, pi, pi, vp, vp, ci, vp, vp]
    lib.ntt_fused_fourstep.restype = ci
    lib.ntt_fused_fourstep.argtypes = (
        [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci] + side + side
        + [vp] * 6 + [ctypes.c_uint] * 3 + [vp])
    lib.ntt_fused_kernel_info.restype = ci
    lib.ntt_fused_kernel_info.argtypes = [ci] * 6 + [pi] * 3
    lib.ntt_fused_error_string.restype = ctypes.c_char_p
    lib.ntt_fused_error_string.argtypes = [ci]
    lib.ntt_reduction_name.restype = ctypes.c_char_p
    if lib.ntt_reduction_name().decode() != reduction:
        raise RuntimeError(f"the {reduction} fused library was built for "
                           f"{lib.ntt_reduction_name().decode()}")
    return lib


def _check(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA fused four-step {what} failed: "
                           + lib.ntt_fused_error_string(err).decode())


def kernel_info(ff: FusedFourstep, batch: int = 1) -> dict:
    """What the card gives ff's kernel at this batch, in the library of
    ff's reduction: the build's register group size (kfuse), its registers
    a thread, its co-resident blocks per SM under the cooperative launch,
    and the grid it launches with."""
    nn_a, nn_b = ff.shape_in
    tl_a, tl_b = fused_shape_check(nn_a, nn_b, batch)
    lib = _library(ff.red.name)
    kfuse, regs, per_sm = (ctypes.c_int() for _ in range(3))
    with torch.cuda.device(ff.wmid.device):
        _check(lib.ntt_fused_kernel_info(
            int(ff.pre is not None), int(ff.post is not None), nn_a, nn_b,
            tl_a.bit_length() - 1, tl_b.bit_length() - 1, kfuse, regs,
            per_sm), lib, "occupancy query")
        sms = torch.cuda.get_device_properties(
            ff.wmid.device).multi_processor_count
    tiles = batch * max(nn_b // tl_a, nn_a // tl_b)
    return {"kfuse": kfuse.value, "registers": regs.value,
            "blocks_per_sm": per_sm.value, "sms": sms,
            "grid": min(tiles, per_sm.value * sms)}


def _ptrs(t):
    return [None, None] if t is None else [t[0].data_ptr(), t[1].data_ptr()]


def _launch(xb: torch.Tensor, ff: FusedFourstep) -> torch.Tensor:
    tables = {"net_a.tw": ff.net_a.tw, "net_a.wmid": ff.net_a.wmid,
              "net_b.tw": ff.net_b.tw, "net_b.wmid": ff.net_b.wmid,
              "wmid": ff.wmid, "pre": ff.pre, "post": ff.post}
    for name, t in tables.items():
        if t is not None and t.device != xb.device:
            raise ValueError(f"fused_fourstep table {name} is on {t.device}, "
                             f"input on {xb.device}")
    if not xb.is_contiguous():
        raise ValueError("the fused four-step kernel takes contiguous tensors")
    B, nn_a, nn_b = xb.shape
    tl_a, tl_b = fused_shape_check(nn_a, nn_b, B)
    # The scratch is released on return, while the kernel may still run:
    # the caching allocator hands its memory out again only in the order
    # of the stream the kernel runs on.
    scratch = torch.empty((B, nn_b, nn_a), dtype=torch.int32,
                          device=xb.device)
    out = torch.empty_like(scratch)
    lib = _library(ff.red.name)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        err = lib.ntt_fused_fourstep(
            xb.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            ff.counters(stream).data_ptr(), B, nn_a, nn_b,
            tl_a.bit_length() - 1, tl_b.bit_length() - 1, int(ff.inverse),
            *C.network_args(ff.net_a), *C.network_args(ff.net_b),
            *_ptrs(ff.wmid), *_ptrs(ff.pre), *_ptrs(ff.post), ff.red.p,
            *ff.red.consts, stream)
    _check(err, lib, "launch")
    fused_fourstep.launches += 1
    return out


def fused_fourstep(x: torch.Tensor, ff: FusedFourstep) -> torch.Tensor:
    """Run one fused transform: the CUDA kernel (one cooperative launch)
    for a CUDA tensor, the plain version for a CPU tensor.
    ``fused_fourstep.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return fused_fourstep_plain(x, ff)
    if x.device.type != "cuda":
        raise ValueError(f"no fused four-step transform for device {x.device}")
    xb, squeeze = _batched(x, ff)
    out = _launch(xb, ff)
    return out[0] if squeeze else out


fused_fourstep.launches = 0
