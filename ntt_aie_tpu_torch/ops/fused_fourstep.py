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
is a batch of one.

A side above one launch (more than colpass.LAUNCH_ROWS rows), or of one
row, makes the one cooperative launch a short list of steps with a grid
sync between them (``fused_steps``): each side the launches its column
pass would run on the card (``colpass.launch_plan``: a whole column, or
its tall route's phases, a phase above LAUNCH_ROWS rows split in two),
side a with 'pre' on its first load and wmid on its transposing store,
side b with 'post' and canonicalize on its last store; a side of one row
is one elementwise step of its operands. ``fused_step_plain`` is one
step's plain version. The kernel takes each step's tiles from its own
counter and resets them itself (step 0's is zero after every launch, the
others are zeroed as it starts), so two launches that overlap must not
share them: ``FusedFourstep.counters`` keeps one buffer per CUDA stream,
and launches on one stream run one after another.
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

# csrc/fused_fourstep.cu StepCode
(STEP_WHOLE_A, STEP_WHOLE_A_PRE, STEP_WHOLE_B, STEP_WHOLE_B_POST,
 STEP_TALL_A_PRE, STEP_TALL_A, STEP_TALL_PRE, STEP_IN_PLACE, STEP_TALL_BT,
 STEP_TALL_B_POST, STEP_ROW) = range(11)
_WHOLE = (STEP_WHOLE_A, STEP_WHOLE_A_PRE, STEP_WHOLE_B, STEP_WHOLE_B_POST)
# csrc/fused_fourstep.cu StepSet: the step kernel's instantiations
STEP_SETS = ("tall", "all")
_THREADS = 256  # csrc/fused_fourstep.cu kThreads
# csrc/fused_fourstep.cu StepBuf
_BUFS = {"x": 0, "out": 1, "scratch": 2}
_STAGES = 16  # colpass_tile.cuh kMaxStages
_STEP_INTS = 15 + 2 * _STAGES
_STEP_PTRS = 13


@dataclasses.dataclass(frozen=True, eq=False)
class FusedFourstep:
    """One fused transform: its two column networks and its elementwise
    operands, prepared once on the plan's device as int32 tensors.

    wmid: (2, nn_b, nn_a) four-step twiddle matrix in the reduction's pair
      form (``Reduction.pair``), as pre and post are.
    pre: (2, nn_a, nn_b) multiply before side a, or None.
    post: (2, nn_b, nn_a) multiply after side b, or None.
    sides: the two sides as column passes with their operands (side a:
      net_a with pre as 'pre', wmid as 'post_t', transposing; side b:
      net_b with post as 'post', canonicalize), the passes whose launches
      are the kernel's steps (``fused_steps``); a tall side's operands are
      contiguous pairs (the steps' tables), a whole side's views of the
      planes above.
    streams: the kernel's tile counters, one int32 buffer (a counter a
      step) per CUDA stream handle (``counters``).
    steps: ``fused_steps``' lists by row limit, and each list's launch
      arguments, made at first use.
    """

    red: Reduction
    inverse: bool
    net_a: C.ColPass
    net_b: C.ColPass
    wmid: torch.Tensor
    pre: torch.Tensor | None
    post: torch.Tensor | None
    sides: tuple = ()
    streams: dict = dataclasses.field(default_factory=dict, repr=False)
    steps: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape_in(self) -> tuple:
        return (self.net_a.nn, self.net_b.nn)

    def counters(self, stream: int, steps: int = 2) -> torch.Tensor:
        """The tile counters of a launch of `steps` steps (two for two
        whole sides, one a step) on the stream with this handle: made zero
        on the plan's device at the first call, or where the buffer has
        fewer counters (on the current stream, so before any launch that
        uses them). Each launch leaves step 0's at zero and zeroes the
        others before it takes their tiles."""
        buf = self.streams.get(stream)
        if buf is None or buf.numel() < steps:
            buf = torch.zeros(steps, dtype=torch.int32,
                              device=self.wmid.device)
            self.streams[stream] = buf
        return buf

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

    wmid_t = operand(wmid, (nn_b, nn_a), "wmid")
    pre_t = operand(pre, (nn_a, nn_b), "pre")
    post_t = operand(post, (nn_b, nn_a), "post")

    def pairs(t, net):  # (2, r, c) -> (r, c, 2), contiguous for a tall side
        if t is None:
            return None
        t = t.movedim(0, -1)
        return t.contiguous() if net.tall is not None else t

    sides = (dataclasses.replace(net_a, pre=pairs(pre_t, net_a),
                                 wmat=pairs(wmid_t, net_a),
                                 transpose_out=True),
             dataclasses.replace(net_b, post=pairs(post_t, net_b),
                                 canonicalize=True))
    return FusedFourstep(red=red, inverse=inverse, net_a=net_a, net_b=net_b,
                         wmid=wmid_t, pre=pre_t, post=post_t, sides=sides)


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


def fused_steps(ff: FusedFourstep, *, max_rows: int | None = None) -> list:
    """The steps of ff's launch, in order: side a's launches
    (colpass.launch_plan of ff.sides[0] over nn_b columns), then side b's
    (of ff.sides[1] over nn_a): a whole side's one step, a one-row side's
    one elementwise step (STEP_ROW), a tall side's its tall route's. Each a
    dict: "name" (the side, and a tall launch's suffix: 'a', 'bA', 'bB1',
    ...), "side", "cp" (the side's pass), "launch", "code"
    (csrc/fused_fourstep.cu StepCode), "tile_cols" (the launch's, or for a
    whole side whose tile would hold fewer values than a block has
    threads, as many columns as make it hold that many, up to the side's
    columns), and its buffers "src" ('x', then the previous step's "dst")
    and "dst" ('out' and 'scratch' in turn, so the last step writes
    'out'). max_rows: launch_plan's (by default colpass.LAUNCH_ROWS; the
    card's checks lower it to run split phases at small sizes). Made once
    a row limit (ff.steps)."""
    if max_rows is None:
        max_rows = C.LAUNCH_ROWS
    if max_rows in ff.steps:
        return ff.steps[max_rows]
    nn_a, nn_b = ff.shape_in
    side_a, side_b = ff.sides
    plan = ([("a", side_a, launch)
             for launch in C.launch_plan(side_a, nn_b, max_rows=max_rows)]
            + [("b", side_b, launch)
               for launch in C.launch_plan(side_b, nn_a, max_rows=max_rows)])
    out = []
    for k, (side, cp, launch) in enumerate(plan):
        tall = launch["tall"]
        tl = launch["tile_cols"]
        if tall == C.TALL_WHOLE and cp.nn == 1:
            code = STEP_ROW
        elif tall == C.TALL_WHOLE and side == "a":
            code = STEP_WHOLE_A_PRE if ff.pre is not None else STEP_WHOLE_A
        elif tall == C.TALL_WHOLE:
            code = STEP_WHOLE_B_POST if ff.post is not None else STEP_WHOLE_B
        elif tall == C.TALL_A:
            code = (STEP_TALL_A_PRE if launch["pre_form"] != C.OP_NONE
                    else STEP_TALL_A)
        elif tall == C.TALL_PRE:
            code = STEP_TALL_PRE
        elif side == "a" and launch["store_ops"]:
            code = STEP_TALL_BT
        elif launch["post_form"] != C.OP_NONE:
            code = STEP_TALL_B_POST
        else:  # in place, or side b's last without 'post'
            code = STEP_IN_PLACE
        if code in _WHOLE:
            tl = max(tl, min(launch["ncols"], _THREADS // cp.nn))
        suffix = launch["key"].rpartition("+tall")[2] if tall else ""
        out.append({"name": side + suffix, "side": side, "cp": cp,
                    "launch": launch, "code": code, "tile_cols": tl,
                    "src": out[-1]["dst"] if out else "x",
                    "dst": "out" if (len(plan) - 1 - k) % 2 == 0
                    else "scratch"})
    return ff.steps.setdefault(max_rows, out)


def step_prefix(ff: FusedFourstep, k: int, *,
                max_rows: int | None = None) -> list:
    """fused_steps(ff, max_rows=...) with its buffers bound again so that
    step k writes 'out', for the card's checks of each step: they launch
    its steps 0 .. k alone (``_launch(..., run=k + 1)``: the step kernel
    at the whole list's instantiation, grid and shared memory) and hold
    the output, viewed as step k's, against fused_step_plain's chain up to
    k. Made once a prefix (ff.steps)."""
    if max_rows is None:
        max_rows = C.LAUNCH_ROWS
    steps = fused_steps(ff, max_rows=max_rows)
    if not 0 <= k < len(steps):
        raise ValueError(f"no step {k} of a list of {len(steps)}")
    key = ("prefix", max_rows, k)
    got = ff.steps.get(key)
    if got is not None:
        return got
    out = []
    for j, st in enumerate(steps):
        out.append(dict(st, src=out[-1]["dst"] if out else "x",
                        dst="out" if (k - j) % 2 == 0 else "scratch"))
    return ff.steps.setdefault(key, out)


def fused_key(ff: FusedFourstep, steps: list | None = None) -> str:
    """``fused_fourstep.launches_by``'s key of a launch of ff: its
    direction and operands, and its steps' names (fused_steps, or these),
    e.g. 'dif+pre:a,b' or 'dit:aA,aB,b'."""
    parts = ["dit" if ff.inverse else "dif"]
    parts += [name for name, t in (("pre", ff.pre), ("post", ff.post))
              if t is not None]
    names = [st["name"] for st in (steps or fused_steps(ff))]
    return "+".join(parts) + ":" + ",".join(names)


def fused_step_plain(x: torch.Tensor, ff: FusedFourstep, k: int, *,
                     max_rows: int | None = None) -> torch.Tensor:
    """Step k of ff's launch (``fused_steps``) in plain PyTorch ops, in its
    own view: x holds the step's input (B * n values: the transform's
    input for step 0, the previous step's output after it), viewed as its
    side's (B, nn, ncols); the output is colpass.launch_plain's, (B, nn,
    ncols), or (B, ncols, nn) where the step transposes. The steps compose
    to fused_fourstep_plain bit for bit (at any max_rows of
    fused_steps)."""
    step = fused_steps(ff, max_rows=max_rows)[k]
    cp = step["cp"]
    ncols = ff.net_b.nn if step["side"] == "a" else ff.net_a.nn
    return C.launch_plain(x.reshape(-1, cp.nn, ncols), cp, step["launch"])


# ---- CUDA kernel -----------------------------------------------------------

def fused_shape_check(nn_a: int, nn_b: int, batch: int, *,
                      inverse: bool = False) -> tuple:
    """The H100 route's limits, checked before a launch: each side a power
    of two, and at most 2^30 tiles a step. Returns the tile width (TL) of
    each step (``fused_steps``: (TL_a, TL_b) where each side fits a tile,
    colpass.tile_cols' rules; a tall side's launches' otherwise,
    colpass.launch_shapes of the forward (DIF) or inverse (DIT) network);
    raises ValueError above the limits."""
    if batch < 1:
        raise ValueError(f"batch must be at least 1, got {batch}")
    direction = "dit" if inverse else "dif"
    try:
        shapes = (C.launch_shapes(nn_a, nn_b, direction)
                  + C.launch_shapes(nn_b, nn_a, direction))
    except ValueError as e:
        raise ValueError(
            f"the fused four-step kernel does not take ({nn_a}, {nn_b}): "
            f"each side must be a power of two ({e})") from None
    if max(batch * mult * ncols // tl
           for _, ncols, mult, tl in shapes) > (1 << 30):
        raise ValueError(f"the fused four-step kernel takes at most 2^30 "
                         f"tiles a step; batch {batch} of ({nn_a}, {nn_b}) "
                         "is more")
    return tuple(tl for *_, tl in shapes)


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
    lib.ntt_fused_steps.restype = ci
    lib.ntt_fused_steps.argtypes = ([vp] * 4 + [ci] * 4 + [pi, vp]
                                    + [ctypes.c_uint] * 3 + [vp])
    lib.ntt_fused_steps_info.restype = ci
    lib.ntt_fused_steps_info.argtypes = [ci, ci, pi, vp] + [pi] * 4
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


def _whole(steps) -> bool:
    """Whether a step list is two whole sides (fused_kernel's launch)."""
    return len(steps) == 2 and all(st["code"] in _WHOLE for st in steps)


def _planes(t):
    return [None, None] if t is None else [t[0].data_ptr(), t[1].data_ptr()]


def _step_args(ff: FusedFourstep, steps: list) -> tuple:
    """The step list as csrc/fused_fourstep.cu's host description: a C
    array of _STEP_INTS ints a step and one of _STEP_PTRS pointers
    (StepInt, StepPtr); made once a list (ff.steps)."""
    key = ("args", id(steps))
    got = ff.steps.get(key)
    if got is not None and got[0] is steps:
        return got[1]
    ints, ptrs = [], []
    for st in steps:
        cp, launch, code = st["cp"], st["launch"], st["code"]
        whole = code in _WHOLE or code == STEP_ROW
        ts, offs = list(launch["ts"]), list(launch["offsets"])
        n = len(ts)
        ints += [code, _BUFS[st["src"]], _BUFS[st["dst"]], launch["rows"],
                 launch["ncols"], st["tile_cols"].bit_length() - 1,
                 launch["batch_mult"], n,
                 len(cp.phases_ts[0]) if whole else n,
                 C._log_a(cp) if whole else -1,
                 int(launch["canonicalize"]),
                 launch["inner"].bit_length() - 1, launch["log_hq"],
                 launch["log_lp"], launch["shift"]]
        ints += ts + [1] * (_STAGES - n) + offs + [0] * (_STAGES - n)
        if whole:
            mats = ff.wmid if st["side"] == "a" else ff.post
            ptrs += (_planes(cp.tw) + _planes(cp.wmid)
                     + _planes(ff.pre if st["side"] == "a" else None)
                     + _planes(mats) + [None] * 5)
        else:
            ptrs += [None] * 8 + [
                launch["phase"].tw_pairs.data_ptr(), cp.wmid_pairs.data_ptr(),
                C._ptr(launch["mat"]), C._ptr(launch["pre"]),
                C._ptr(launch["post"])]
    if (len(ints), len(ptrs)) != (_STEP_INTS * len(steps),
                                   _STEP_PTRS * len(steps)):
        raise RuntimeError("the step description disagrees with "
                           "csrc/fused_fourstep.cu StepInt/StepPtr")
    args = ((ctypes.c_int * len(ints))(*ints),
            (ctypes.c_void_p * len(ptrs))(*ptrs))
    ff.steps[key] = (steps, args)
    return args


def kernel_info(ff: FusedFourstep, batch: int = 1) -> dict:
    """What the card gives ff's kernel at this batch, in the library of
    ff's reduction: the build's register group size (kfuse), its registers
    a thread, its co-resident blocks per SM under the cooperative launch,
    the grid it launches with, its steps' names and tile widths
    (``fused_steps``), and its kernel: two whole sides run fused_kernel
    ("kernel": "fused"), any other list an instantiation of
    fused_steps_kernel ("steps:<set>", STEP_SETS)."""
    nn_a, nn_b = ff.shape_in
    tls = fused_shape_check(nn_a, nn_b, batch, inverse=ff.inverse)
    steps = fused_steps(ff)
    lib = _library(ff.red.name)
    kfuse, kset, regs, per_sm = (ctypes.c_int() for _ in range(4))
    with torch.cuda.device(ff.wmid.device):
        if _whole(steps):
            kernel = "fused"
            _check(lib.ntt_fused_kernel_info(
                int(ff.pre is not None), int(ff.post is not None), nn_a,
                nn_b, tls[0].bit_length() - 1, tls[1].bit_length() - 1,
                kfuse, regs, per_sm), lib, "occupancy query")
        else:
            ints, ptrs = _step_args(ff, steps)
            _check(lib.ntt_fused_steps_info(
                int(ff.inverse), len(steps), ints, ptrs, kfuse, kset, regs,
                per_sm), lib, "occupancy query")
            kernel = "steps:" + STEP_SETS[kset.value]
        sms = torch.cuda.get_device_properties(
            ff.wmid.device).multi_processor_count
    tiles = max(batch * st["launch"]["batch_mult"] * st["launch"]["ncols"]
                // st["tile_cols"] for st in steps if st["code"] != STEP_ROW)
    return {"kernel": kernel, "kfuse": kfuse.value,
            "registers": regs.value, "blocks_per_sm": per_sm.value,
            "sms": sms, "grid": min(tiles, per_sm.value * sms),
            "steps": [st["name"] for st in steps],
            "tile_cols": [st["tile_cols"] for st in steps]}


def _launch(xb: torch.Tensor, ff: FusedFourstep, steps: list | None = None,
            run: int | None = None) -> torch.Tensor:
    """ff's launch on xb: its fused_steps, or these (fused_steps(ff,
    max_rows=...) or a step_prefix, which the card's checks run); run: the
    steps to run (the list's all; a prefix for the checks)."""
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
    tls = fused_shape_check(nn_a, nn_b, B, inverse=ff.inverse)
    if steps is None:
        steps = fused_steps(ff)
    # The scratch is released on return, while the kernel may still run:
    # the caching allocator hands its memory out again only in the order
    # of the stream the kernel runs on.
    scratch = torch.empty((B, nn_b, nn_a), dtype=torch.int32,
                          device=xb.device)
    out = torch.empty_like(scratch)
    lib = _library(ff.red.name)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        if run is None and _whole(steps):
            err = lib.ntt_fused_fourstep(
                xb.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                ff.counters(stream).data_ptr(), B, nn_a, nn_b,
                tls[0].bit_length() - 1, tls[1].bit_length() - 1,
                int(ff.inverse), *C.network_args(ff.net_a),
                *C.network_args(ff.net_b), *_planes(ff.wmid),
                *_planes(ff.pre), *_planes(ff.post), ff.red.p,
                *ff.red.consts, stream)
        else:
            ints, ptrs = _step_args(ff, steps)
            err = lib.ntt_fused_steps(
                xb.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                ff.counters(stream, len(steps)).data_ptr(), B,
                int(ff.inverse), len(steps), run or len(steps), ints, ptrs,
                ff.red.p, *ff.red.consts, stream)
    _check(err, lib, "launch")
    key = fused_key(ff, steps[:run])
    fused_fourstep.launches += 1
    by = fused_fourstep.launches_by
    by[key] = by.get(key, 0) + 1
    return out


def fused_fourstep(x: torch.Tensor, ff: FusedFourstep) -> torch.Tensor:
    """Run one fused transform: the CUDA kernel (one cooperative launch)
    for a CUDA tensor, the plain version for a CPU tensor.
    ``fused_fourstep.launches`` counts kernel launches,
    ``fused_fourstep.launches_by`` them by transform and step list
    (``fused_key``: 'dif:a,b' for two whole sides, 'dif:a,bA,bB' with side
    b tall)."""
    if x.device.type == "cpu":
        return fused_fourstep_plain(x, ff)
    if x.device.type != "cuda":
        raise ValueError(f"no fused four-step transform for device {x.device}")
    xb, squeeze = _batched(x, ff)
    out = _launch(xb, ff)
    return out[0] if squeeze else out


fused_fourstep.launches = 0
fused_fourstep.launches_by = {}
