"""The nested R x S column pass: a CUDA kernel and its plain PyTorch
version.

Port of ``scripts/proto_nested_colpass.py`` ``nested_colpass`` (the
round-4 Pallas prototype of the nested column pass): a DIF over n1 rows
down each column of an (n1, n2) or (batch, n1, n2) array, decomposed as
R x S, over p = 469762049 with harvey4. Phase 0 runs the DIF over R with
the S sub-rows riding inside each stage, then every row is multiplied by
the inner four-step matrix, the row at r*S + s moves to s*R + r, and
phase 1 runs the DIF over S. The tables are the prototype's, from the
port's own twiddles: ``dif_stage_twiddles(R)`` repeated S times,
``dif_stage_twiddles(S)`` repeated R times, and the flattened
``fourstep_tables(R, S)["wmat"]``. R is any power of two dividing n1
(default 2^floor(log2(n1)/2)); where it equals ``nested_col_split(n1)``
the output equals the column pass's (``colpass``) bit for bit.

Output: lazy, [0, 4p), no canonicalize, rows in the order
``spectral_positions(R, S)`` relative to the natural DFT order.

``fuse`` groups up to that many consecutive stages of a phase into one
radix-2^k step, as the prototype does; on the card a group is k stages
held in registers between two exchanges through the column pass's
swizzled shared-memory tile (``csrc/colpass_tile.cuh`` column_tile_io).
It does not change the output. ``nested_colpass(x, nc)`` is the entry
point: the kernel in ``csrc/nested_colpass.cu`` on a CUDA tensor, the
plain version ``nested_colpass_plain`` on a CPU tensor, and a raise
otherwise. ``kernel_info(nc)`` says what the card gives the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.fields import P_469762049 as FIELD
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops.reductions import make_reduction
from ntt_aie_tpu_torch.utils.device import resolve_device

MAX_FUSE = 5  # csrc/nested_colpass.cu kMaxFuse


@dataclasses.dataclass(frozen=True, eq=False)
class NestedColPass:
    """One nested column pass: its shape, grouping and network. ``net`` is
    a nested DIF ``colpass.ColPass`` over n1 = net.nn rows with phases
    (R-phase, S-phase), mid_rs (R, S) and the prototype's tables, prepared
    once on the pass's device; its store options are off."""

    n2: int
    batch: int
    fuse: int
    net: C.ColPass

    @property
    def shape(self) -> tuple:
        """The prototype's: (n1, n2), or (batch, n1, n2) when batch > 1."""
        n1 = self.net.nn
        return (n1, self.n2) if self.batch == 1 else (self.batch, n1,
                                                      self.n2)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return nested_colpass(x, self)


def _pow2(v: int) -> bool:
    return v >= 1 and v & (v - 1) == 0


def make_nested_colpass(n1: int, n2: int, *, R: int | None = None,
                        batch: int = 1, fuse: int = 3, device=None):
    """fn(x) -> y: DIF over n1 rows via nested R x S, as the prototype's
    ``nested_colpass``. Returns (fn, {"R": R, "S": S}); fn takes and
    returns (n1, n2) int32 tensors, or (batch, n1, n2) when batch > 1.
    device: None is the card (utils.device.resolve_device)."""
    device = resolve_device(device)
    if not _pow2(n1) or n1 < 2:
        raise ValueError(f"n1 must be a power of two >= 2, got {n1}")
    R = R or 1 << ((n1.bit_length() - 1) // 2)
    if not _pow2(R) or n1 % R:
        raise ValueError(f"R must be a power of two dividing {n1}, got {R}")
    if fuse < 1:
        raise ValueError(f"fuse must be at least 1, got {fuse}")
    if n2 < 1 or batch < 1:
        raise ValueError(f"n2 and batch must be positive, got {n2}, {batch}")
    S = n1 // R
    red = make_reduction("harvey4", FIELD)
    stage_tabs = ([red.pair(np.repeat(v, S))
                   for v in tw.dif_stage_twiddles(FIELD, R)]
                  + [red.pair(np.repeat(v, R))
                     for v in tw.dif_stage_twiddles(FIELD, S)])
    mid_tab = red.pair(tw.fourstep_tables(FIELD, R, S)["wmat"].ravel())
    logR, logS = R.bit_length() - 1, S.bit_length() - 1
    ts_R = [(R >> (s + 1)) * S for s in range(logR)]
    ts_S = [(S >> (s + 1)) * R for s in range(logS)]
    net = C._assemble(red, n1, "dif", [ts_R, ts_S], (R, S), stage_tabs,
                      mid_tab, {}, False, False, device)
    nc = NestedColPass(n2=n2, batch=batch, fuse=fuse, net=net)
    return nc, {"R": R, "S": S}


def _checked(x: torch.Tensor, nc: NestedColPass) -> torch.Tensor:
    """x as (batch, n1, n2), after checking its type and shape."""
    if x.dtype != torch.int32:
        raise TypeError(f"nested_colpass takes int32 tensors, got {x.dtype}")
    if tuple(x.shape) != nc.shape:
        raise ValueError(f"this nested pass takes {nc.shape}, got "
                         f"{tuple(x.shape)}")
    return x.reshape(nc.batch, nc.net.nn, nc.n2)


def nested_colpass_plain(x: torch.Tensor, nc: NestedColPass) -> torch.Tensor:
    """The nested column pass in plain PyTorch ops (int64 carriers, the
    column pass's ``run_network``), on any device: the CPU route and the
    oracle the kernel is held against."""
    xb = _checked(x, nc)
    v = C.run_network(M.to_carrier(xb), nc.net)
    return M.from_carrier(v).contiguous().reshape(nc.shape)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(C.build_library("nested_colpass")))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    pi = ctypes.POINTER(ctypes.c_int)
    lib.ntt_nested_colpass.restype = ci
    lib.ntt_nested_colpass.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                       pi, pi, vp, ci, vp, ctypes.c_uint,
                                       vp]
    lib.ntt_nested_error_string.restype = ctypes.c_char_p
    lib.ntt_nested_error_string.argtypes = [ci]
    lib.ntt_nested_max_fuse.restype = ci
    lib.ntt_nested_kernel_info.restype = ci
    lib.ntt_nested_kernel_info.argtypes = [ci, ci, ci, pi, pi]
    if lib.ntt_nested_max_fuse() != MAX_FUSE:
        raise RuntimeError("csrc/nested_colpass.cu kMaxFuse disagrees with "
                           "MAX_FUSE")
    return lib


def _check_fuse(nc: NestedColPass) -> None:
    if nc.fuse > MAX_FUSE:
        raise ValueError(f"the CUDA nested column pass groups at most "
                         f"{MAX_FUSE} stages in registers, got fuse="
                         f"{nc.fuse}")


def kernel_info(nc: NestedColPass) -> dict:
    """What the card gives nc's kernel: its fuse, the tile width TL and the
    swizzled tile's shift (``colpass.tile_shift``), and the kernel's
    registers a thread and co-resident blocks per SM."""
    _check_fuse(nc)
    net = nc.net
    tl = C.tile_cols(net.nn, nc.n2)
    log_tl = tl.bit_length() - 1
    lib = _library()
    regs, per_sm = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(net.tw.device):
        err = lib.ntt_nested_kernel_info(nc.fuse, net.nn, log_tl, regs,
                                         per_sm)
    if err != 0:
        raise RuntimeError("CUDA nested column pass occupancy query failed: "
                           + lib.ntt_nested_error_string(err).decode())
    return {"fuse": nc.fuse, "tile_cols": tl,
            "shift": C.tile_shift(net, log_tl), "registers": regs.value,
            "blocks_per_sm": per_sm.value}


def _launch(xb: torch.Tensor, nc: NestedColPass) -> torch.Tensor:
    net = nc.net
    for name, t in (("tw", net.tw_pairs), ("wmid", net.wmid_pairs)):
        if t.device != xb.device:
            raise ValueError(f"nested_colpass table {name} is on {t.device}, "
                             f"input on {xb.device}")
    if not xb.is_contiguous():
        raise ValueError("the CUDA nested column pass takes contiguous "
                         "tensors")
    _check_fuse(nc)
    B, nn, c = xb.shape
    tl = C.tile_cols(nn, c)
    out = torch.empty_like(xb)
    args = [*C._stage_args(net), net.tw_pairs.data_ptr(), C._log_a(net),
            net.wmid_pairs.data_ptr()]
    lib = _library()
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        for b0, b1 in C.launch_batches(B):
            err = lib.ntt_nested_colpass(
                xb[b0:b1].data_ptr(), out[b0:b1].data_ptr(), b1 - b0, nn, c,
                tl.bit_length() - 1, nc.fuse, *args, net.red.p, stream)
            if err != 0:
                raise RuntimeError(
                    "CUDA nested column pass launch failed: "
                    + lib.ntt_nested_error_string(err).decode())
            nested_colpass.launches += 1
    return out


def nested_colpass(x: torch.Tensor, nc: NestedColPass) -> torch.Tensor:
    """Run one nested column pass: the CUDA kernel for a CUDA tensor (one
    launch per colpass.MAX_LAUNCH_BATCH batch rows), the plain version for
    a CPU tensor. ``nested_colpass.launches`` counts
    kernel launches."""
    if x.device.type == "cpu":
        return nested_colpass_plain(x, nc)
    if x.device.type != "cuda":
        raise ValueError(f"no nested column pass for device {x.device}")
    return _launch(_checked(x, nc), nc).reshape(nc.shape)


nested_colpass.launches = 0
