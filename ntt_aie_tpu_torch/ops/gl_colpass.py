"""The Goldilocks column pass: a CUDA kernel and its plain PyTorch version.

Port of ``ntt_aie_tpu/ops/pallas_gl.py`` (the Pallas kernel
``build_gl_colpass`` and its wrapper ``make_gl_colpass``) for the
configurations the Goldilocks plans run (``goldilocks_plan.gl_fold_passes``):
the fold arm's ``cp1`` (DIF, transpose_out, then the 'post_t' wmat
multiply), ``cp2`` (DIF), ``icp2`` (DIT, transpose_out, then the 'post_t'
iwmat multiply) and ``icp1`` (DIT); the ``wmat_fold=False`` arm's cp2 and
icp1 with the matrix as 'pre'; the ``wmat_factored=True`` arm's cp2 with
the factored ``wfac`` as 'pre' and icp2 with it as 'post'; and the
distributed plan's passes (``parallel.fourstep.gl_dist_passes``), which
never transpose: a 'post' matrix (the full-matrix arm's wmat, after the
stages), two matrices in one pass ('pre' psi and 'post' wmat, or 'pre'
iwmat and 'post' psi^-1) and the reference's rank-1 operand (the
factored arm's psi). The operands apply in the reference's order
(``pallas_gl.py:161-168``, ``:294-301``): the 'pre' matrix, wfac and
rank-1 on load, the stages, the 'post' matrix, wfac and rank-1, the
transpose, 'post_t'.

Values mod p = 2^64 - 2^32 + 1 travel as a ``(hi, lo)`` tuple of
``torch.int32`` planes holding uint32 bit patterns: (B, nn, ncols) in,
(B, nn, ncols) out, or (B, ncols, nn) with transpose_out; 2-D planes are
a batch of one. Every step keeps values canonical, [0, p), so the kernel,
the plain version and the reference agree bit for bit, whatever exact
method each multiplies with.

``gl_colpass(x, cp)`` is the entry point: the plain version,
``gl_colpass_plain``, for CPU tensors, the kernel in ``csrc/gl_colpass.cu``
for CUDA tensors, and a raise otherwise. ``gl_mul(a, b)`` is the pointwise
product between transforms on the same terms, b of a's shape or of its
trailing shape (broadcast over the leading axes, as psi over a batch); its
kernel is a helper in the same library (the reference leaves this product
to XLA).
``kernel_info(cp, ncols)`` says what the card gives the column kernel.

A column of more than colpass.GL_LAUNCH_ROWS = 2,048 rows runs on the
card as two launches, the two phases of its nested network, as the
32-bit pass's tall route (``colpass.tall_phases``;
``gl_tall_phase_plain`` is each launch's plain version), a phase above
GL_LAUNCH_ROWS rows as two launches of its own, split by stage group
(``colpass.phase_groups``; ``gl_launch_plain`` is any launch's plain
version). Goldilocks needs it most: a 32,768-row column of uint64 values
takes 256 KB, more than a block's shared memory, an 8,192-row one a
2-column tile of 128 KB, one block an SM, and a 4,096-row one's DIT
network lost to its route on the card (PERF.md section 6). A column of
one row (the split (1, n)) has no stage: its pass is one elementwise
launch of its operands. A column of 2 to colpass.SHORT_ROWS rows runs on
the short kernel, one thread a column, its values in registers through
every stage.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.utils.device import resolve_device

MAX_ROWS = 8192  # csrc/gl_colpass.cu kMaxRows: the tallest tile


@dataclasses.dataclass(frozen=True, eq=False)
class GLColPass:
    """One Goldilocks column pass: its static configuration and its tables,
    prepared once on the plan's device as int64 tensors holding the uint64
    field values.

    tw: (sum(ts),) the stage twiddles of every stage in order; offsets[s]
      is stage s's start.
    wmid: (nn,) nested mid multiply, or None for a plain network.
    wmat: (ncols, nn) 'post_t' operand, or None.
    pre, post: (nn, ncols) 'pre' and 'post' operands, indexed like the
      input, or None.
    wfac: (T1 (nn/S, ncols), T2 (S, ncols)), the factored four-step matrix
      at wfac_pos ('pre' or 'post'), or None.
    rank1: (row (nn,), col (ncols,)) at rank1_pos, or None.
    tall: for nn > colpass.GL_LAUNCH_ROWS, the two phases of the tall route
      (``colpass.tall_phases``), else None.
    """

    nn: int
    direction: str
    phases_ts: tuple
    mid_rs: tuple
    transpose_out: bool
    tw: torch.Tensor
    offsets: tuple
    wmid: torch.Tensor | None
    wmat: torch.Tensor | None
    pre: torch.Tensor | None = None
    post: torch.Tensor | None = None
    wfac: tuple | None = None
    wfac_pos: str | None = None
    rank1: tuple | None = None
    rank1_pos: str | None = None
    tall: tuple | None = None

    def __call__(self, x: tuple) -> tuple:
        return gl_colpass(x, self)


def _u64_tensor(a, device) -> torch.Tensor:
    a = np.array(a, dtype=np.uint64, order="C")
    return torch.from_numpy(a.view(np.int64)).to(device)


def _factor_tensors(kind, pos, tabs, nn, device) -> tuple:
    """The device tensors of a 'wfac' or 'rank1' operand's two host
    tables, checked (colpass.check_factors)."""
    a, b = (_u64_tensor(t, device) for t in tabs)
    C.check_factors(kind, pos, tuple(a.shape), tuple(b.shape), nn)
    return a, b


def make_gl_colpass(field, nn: int, *, direction: str,
                    inverse_tw: bool = False, wmat: np.ndarray | None = None,
                    twiddle_pos: str = "post_t",
                    wmat2: np.ndarray | None = None,
                    twiddle_pos2: str | None = None,
                    transpose_out: bool = False,
                    wfac: tuple | None = None, wfac_pos: str | None = None,
                    rank1: tuple | None = None, rank1_pos: str | None = None,
                    device=None) -> GLColPass:
    """Build a Goldilocks column pass for nn-point columns from the port's
    own twiddles.col_network. wmat: a host operand at twiddle_pos:
    'post_t' (the default; (ncols, nn), the four-step matrix in output
    orientation, applied after the transpose), 'pre' ((nn, ncols),
    indexed like the input, applied on load) or 'post' ((nn, ncols),
    after the stages, before the transpose); wmat2: a second operand at
    twiddle_pos2, another position than wmat's (the reference's
    twiddle_pos2). wfac: (T1 (nn/S, ncols), T2
    (S, ncols)) of twiddles.fourstep_wfac_T at wfac_pos ('pre' or 'post');
    rank1: (row (nn,), col (ncols,)) of twiddles.negacyclic_psi_factors at
    rank1_pos; each applied as two multiplies, as the reference's
    make_gl_colpass. device: None is the card."""
    device = resolve_device(device)
    if not field.is_goldilocks:
        raise ValueError(f"the Goldilocks column pass needs p = 2^64 - 2^32 "
                         f"+ 1, got p={field.p}")
    if direction not in ("dif", "dit"):
        raise ValueError(f"direction must be 'dif' or 'dit', got {direction!r}")
    if wmat2 is not None and twiddle_pos2 is None:
        raise ValueError("wmat2 needs twiddle_pos2")
    mats = {}
    for tab, pos in ((wmat, twiddle_pos), (wmat2, twiddle_pos2)):
        if tab is None:
            continue
        if pos not in C.POSITIONS:
            raise ValueError(f"twiddle position must be one of "
                             f"{C.POSITIONS}, got {pos!r}")
        if pos in mats:
            raise ValueError(f"wmat and wmat2 are both at {pos!r}")
        if pos == "post_t" and not transpose_out:
            raise ValueError("the 'post_t' multiply needs transpose_out=True")
        wm = _u64_tensor(tab, device)
        rows = wm.shape[-1] if pos == "post_t" else wm.shape[0]
        if wm.dim() != 2 or rows != nn:
            want = f"(ncols, {nn})" if pos == "post_t" else f"({nn}, ncols)"
            raise ValueError(f"{pos} operand {tuple(wm.shape)} is not "
                             f"{want}")
        mats[pos] = wm
    net = tw.col_network(field, nn, direction=direction, inverse=inverse_tw)
    phases_ts = tuple(tuple(int(t) for t in ph["ts"]) for ph in net["phases"])
    ts = [t for ph in phases_ts for t in ph]
    fac = {kind: (pos, _factor_tensors(kind, pos, tabs, nn, device))
           for kind, tabs, pos in (("wfac", wfac, wfac_pos),
                                   ("rank1", rank1, rank1_pos))
           if tabs is not None}
    wfac_pos, wfac_t = fac.get("wfac", (None, None))
    rank1_pos, rank1_t = fac.get("rank1", (None, None))
    cp = GLColPass(
        nn=nn, direction=direction, phases_ts=phases_ts,
        mid_rs=(int(net["R"]), int(net["S"])), transpose_out=transpose_out,
        tw=_u64_tensor(np.concatenate([np.ravel(v) for ph in net["phases"]
                                       for v in ph["vecs"]]
                                      or [np.zeros(0, np.uint64)]), device),
        offsets=C.stage_offsets(ts),
        wmid=(_u64_tensor(net["mid"]["wmid"], device)
              if net["mid"] is not None else None),
        wmat=mats.get("post_t"), pre=mats.get("pre"), post=mats.get("post"),
        wfac=wfac_t, wfac_pos=wfac_pos, rank1=rank1_t, rank1_pos=rank1_pos)
    if nn > C.GL_LAUNCH_ROWS:
        cp = dataclasses.replace(cp, tall=C.tall_phases(cp))
    return cp


# ---- plain PyTorch version -------------------------------------------------

def _planes(x, what: str):
    if not (isinstance(x, tuple) and len(x) == 2):
        raise TypeError(f"{what} takes a (hi, lo) tuple of int32 tensors")
    hi, lo = x
    if hi.dtype != torch.int32 or lo.dtype != torch.int32:
        raise TypeError(f"{what} takes int32 limb planes, got {hi.dtype} "
                        f"and {lo.dtype}")
    if hi.shape != lo.shape or hi.device != lo.device:
        raise ValueError(f"{what}: hi {tuple(hi.shape)} on {hi.device} and "
                         f"lo {tuple(lo.shape)} on {lo.device} differ")
    return hi, lo


def _batched(x, cp: GLColPass):
    hi, lo = _planes(x, "gl_colpass")
    squeeze = hi.dim() == 2
    if squeeze:
        hi, lo = hi.unsqueeze(0), lo.unsqueeze(0)
    if hi.dim() != 3 or hi.shape[1] != cp.nn:
        raise ValueError(f"gl_colpass over {cp.nn} rows takes (B, {cp.nn}, "
                         f"ncols) or ({cp.nn}, ncols) planes, got "
                         f"{tuple(x[0].shape)}")
    for pos, cols in (("post_t", None if cp.wmat is None else
                       cp.wmat.shape[0]),
                      ("pre", None if cp.pre is None else cp.pre.shape[1]),
                      ("post", None if cp.post is None else cp.post.shape[1]),
                      ("wfac", None if cp.wfac is None else
                       cp.wfac[0].shape[1]),
                      ("rank1", None if cp.rank1 is None else
                       cp.rank1[1].shape[0])):
        if cols is not None and cols != hi.shape[2]:
            raise ValueError(f"{pos} operand has {cols} columns, input has "
                             f"{hi.shape[2]}")
    return hi, lo, squeeze


def _limbs(t: torch.Tensor):
    """int64 tensor of uint64 values -> (hi, lo) carriers."""
    return (t >> 32) & M.MASK32, t & M.MASK32


def _run_stages(h, l, w, ts, offsets, direction):
    """Radix-2 butterfly stages over axis 1 of (B, nn, c) limb carriers."""
    B, nn, c = h.shape
    for t, off in zip(ts, offsets):
        hv = h.reshape(B, nn // (2 * t), 2, t, c)
        lv = l.reshape(B, nn // (2 * t), 2, t, c)
        uh, ul, vh, vl = hv[:, :, 0], lv[:, :, 0], hv[:, :, 1], lv[:, :, 1]
        wh, wl = (v[off:off + t].view(1, 1, t, 1) for v in w)
        if direction == "dif":
            ah, al = M.gl_add(uh, ul, vh, vl)
            bh, bl = M.gl_mul(*M.gl_sub(uh, ul, vh, vl), wh, wl)
        else:
            mh, ml = M.gl_mul(vh, vl, wh, wl)
            ah, al = M.gl_add(uh, ul, mh, ml)
            bh, bl = M.gl_sub(uh, ul, mh, ml)
        h = torch.stack((ah, bh), dim=2).reshape(B, nn, c)
        l = torch.stack((al, bl), dim=2).reshape(B, nn, c)
    return h, l


def _mul_limbs(h, l, t: torch.Tensor, shape) -> tuple:
    return M.gl_mul(h, l, *(v.view(shape) for v in _limbs(t)))


def _mul_at(h, l, cp: GLColPass, pos: str) -> tuple:
    """(h, l) (B, rows, c) times cp's operands at 'pre' or 'post', in the
    reference's order: the matrix, wfac (T1[c1] broadcast over c0, then
    T2[c0] over c1, for row c1*S + c0), rank-1 (row[r], then col[c])."""
    B, rr, cc = h.shape
    mat = cp.pre if pos == "pre" else cp.post
    if mat is not None:
        h, l = _mul_limbs(h, l, mat, (1, rr, cc))
    if cp.wfac is not None and cp.wfac_pos == pos:
        t1, t2 = cp.wfac
        s = t2.shape[0]
        h, l = (v.reshape(B, rr // s, s, cc) for v in (h, l))
        h, l = _mul_limbs(h, l, t1, (1, rr // s, 1, cc))
        h, l = _mul_limbs(h, l, t2, (1, 1, s, cc))
        h, l = (v.reshape(B, rr, cc) for v in (h, l))
    if cp.rank1 is not None and cp.rank1_pos == pos:
        row, col = cp.rank1
        h, l = _mul_limbs(h, l, row, (1, rr, 1))
        h, l = _mul_limbs(h, l, col, (1, 1, cc))
    return h, l


def _mid_move(h, l, cp: GLColPass) -> tuple:
    """The nested network's mid step on (B, nn, c) limb carriers: DIF
    multiplies by wmid, then moves the row at r*S + s to s*R + r; DIT
    makes the inverse move, then multiplies."""
    B, nn, c = h.shape
    R, S = cp.mid_rs
    mh, ml = (v.view(1, nn, 1) for v in _limbs(cp.wmid))
    if cp.direction == "dif":
        h, l = M.gl_mul(h, l, mh, ml)
        return tuple(v.view(B, R, S, c).transpose(1, 2).reshape(B, nn, c)
                     for v in (h, l))
    h, l = (v.view(B, S, R, c).transpose(1, 2).reshape(B, nn, c)
            for v in (h, l))
    return M.gl_mul(h, l, mh, ml)


def _store_ops(h, l, cp: GLColPass) -> tuple:
    """What follows the network: the 'post' operands, the transpose and
    'post_t'."""
    h, l = _mul_at(h, l, cp, "post")
    if cp.transpose_out:
        h, l = h.transpose(1, 2), l.transpose(1, 2)
        if cp.wmat is not None:
            h, l = M.gl_mul(h, l, *_limbs(cp.wmat))
    return h, l


def gl_colpass_plain(x: tuple, cp: GLColPass) -> tuple:
    """The Goldilocks column pass in plain PyTorch ops (int64 limb
    carriers), on any device: the oracle the kernel is held against."""
    hi, lo, squeeze = _batched(x, cp)
    h, l = _mul_at(M.to_carrier(hi), M.to_carrier(lo), cp, "pre")
    w = _limbs(cp.tw)
    k0 = len(cp.phases_ts[0])
    h, l = _run_stages(h, l, w, cp.phases_ts[0], cp.offsets[:k0],
                       cp.direction)
    if cp.wmid is not None:
        h, l = _mid_move(h, l, cp)
        h, l = _run_stages(h, l, w, cp.phases_ts[1], cp.offsets[k0:],
                           cp.direction)
    h, l = _store_ops(h, l, cp)
    out = tuple(M.from_carrier(v).contiguous() for v in (h, l))
    return tuple(v[0] for v in out) if squeeze else out


def gl_tall_phase_plain(x: tuple, cp: GLColPass, phase: str) -> tuple:
    """One launch of cp's tall route in plain PyTorch ops
    (colpass.tall_phase_plain on limb planes): phase 'A' takes the input
    planes to the moved ones, phase 'B' those to the pass's output; B's of
    A's output is gl_colpass_plain's output bit for bit. cp: a nested pass
    of any height."""
    ph = (cp.tall or C.tall_phases(cp))["AB".index(phase)]
    return _phase_plain(x, cp, ph, (0, len(ph.ts)), pre=phase == "A",
                        mid=phase == "A", store=phase == "B")


def _phase_plain(x, cp, ph, stages, *, pre, mid, store):
    """colpass._phase_plain on limb planes (gl_tall_phase_plain's and
    gl_launch_plain's)."""
    hi, lo, squeeze = _batched(x, cp)
    s0, s1 = stages
    B, nn, c = hi.shape
    h, l = M.to_carrier(hi), M.to_carrier(lo)
    if pre:
        h, l = _mul_at(h, l, cp, "pre")
    h, l = _run_stages(h.reshape(B, ph.rows, ph.inner * c),
                       l.reshape(B, ph.rows, ph.inner * c), _limbs(ph.tw),
                       ph.ts[s0:s1], ph.offsets[s0:s1], cp.direction)
    h, l = h.reshape(B, nn, c), l.reshape(B, nn, c)
    if mid:
        h, l = _mid_move(h, l, cp)
    elif store:
        h, l = _store_ops(h, l, cp)
    out = tuple(M.from_carrier(v).contiguous() for v in (h, l))
    return tuple(v[0] for v in out) if squeeze else out


def gl_launch_plain(x: tuple, cp: GLColPass, launch: dict) -> tuple:
    """One launch of colpass.launch_plan(cp, ncols) in plain PyTorch ops
    on limb planes (colpass.launch_plain's twin): the whole pass, or the
    launch's stages over its phase's view with the operands it applies."""
    if launch["tall"] == C.TALL_WHOLE:
        return gl_colpass_plain(x, cp)
    return _phase_plain(x, cp, launch["phase"], launch["stages"],
                        pre=launch["pre_form"] != C.OP_NONE,
                        mid=launch["tall"] == C.TALL_A,
                        store=launch["store_ops"])


def _mul_operands(a: tuple, b: tuple) -> tuple:
    """a's and b's planes, b of a's shape or of its trailing shape."""
    ah, al = _planes(a, "gl_mul")
    bh, bl = _planes(b, "gl_mul")
    if (bh.dim() > ah.dim() or ah.shape[ah.dim() - bh.dim():] != bh.shape
            or ah.device != bh.device):
        raise ValueError(f"gl_mul takes b of a's shape or of its trailing "
                         f"shape, on a's device: got {tuple(ah.shape)} on "
                         f"{ah.device} and {tuple(bh.shape)} on {bh.device}")
    return ah, al, bh, bl


def gl_mul_plain(a: tuple, b: tuple) -> tuple:
    """Pointwise a * b mod p on int32 limb planes, in plain PyTorch ops;
    b of a's shape, or of its trailing shape (broadcast over the leading
    axes)."""
    out = M.gl_mul(*(M.to_carrier(v) for v in _mul_operands(a, b)))
    return tuple(M.from_carrier(v) for v in out)


# ---- CUDA kernels ----------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(C.build_library("gl_colpass")))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    pi = ctypes.POINTER(ctypes.c_int)
    lib.ntt_gl_colpass.restype = ci
    ll = ctypes.c_longlong
    lib.ntt_gl_colpass.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                   ci, pi, pi, vp, ci, vp, vp, ci, vp, vp,
                                   ci, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                   vp]
    lib.ntt_gl_mul.restype = ci
    lib.ntt_gl_mul.argtypes = [vp, vp, vp, vp, vp, vp, ll, ll, vp]
    lib.ntt_gl_error_string.restype = ctypes.c_char_p
    lib.ntt_gl_error_string.argtypes = [ci]
    lib.ntt_gl_colpass_max_rows.restype = ci
    lib.ntt_gl_colpass_short_rows.restype = ci
    lib.ntt_gl_colpass_kernel_info.restype = ci
    lib.ntt_gl_colpass_kernel_info.argtypes = [ci] * 10 + [pi] * 3
    if lib.ntt_gl_colpass_max_rows() != MAX_ROWS:
        raise RuntimeError("csrc/gl_colpass.cu kMaxRows disagrees with "
                           "MAX_ROWS")
    if lib.ntt_gl_colpass_short_rows() != C.SHORT_ROWS:
        raise RuntimeError("csrc/gl_colpass.cu kShortRows disagrees with "
                           "colpass.SHORT_ROWS")
    return lib


def kernel_info(cp: GLColPass, ncols: int) -> dict:
    """What the card gives cp's kernel over (.., cp.nn, ncols): the build's
    register group size (kfuse), the tile width TL, its layout and shift
    (two uint32 planes, each on ``colpass.tile_address``'s swizzled map;
    a short column's layout "registers", TL 1), the launch's rows, and the
    kernel's registers a thread and co-resident blocks per SM; a tall cp's
    launches under "phases" (colpass.launch_plan). cp must lie on the
    card."""
    if cp.tw.device.type != "cuda":
        raise ValueError(f"kernel_info reads the card: cp's tables are on "
                         f"{cp.tw.device}")
    lib = _library()
    return C.launch_info(cp, ncols, lib.ntt_gl_colpass_kernel_info,
                         lib.ntt_gl_error_string, itemsize=8)


variant = C.variant


def _operand_forms(cp: GLColPass) -> tuple:
    """(form, table, second table) of cp's 'pre' and of its 'post'
    operand, in colpass's Operand forms: one form a position (the kernel
    runs one), else ValueError."""
    out = []
    for pos in C.FACTOR_POSITIONS:
        mat = cp.pre if pos == "pre" else cp.post
        forms = [(C.OP_MAT, mat, None)] if mat is not None else []
        if cp.wfac is not None and cp.wfac_pos == pos:
            forms.append((C.OP_FAC, *cp.wfac))
        if cp.rank1 is not None and cp.rank1_pos == pos:
            forms.append((C.OP_RANK1, *cp.rank1))
        if len(forms) > 1:
            raise ValueError(f"the CUDA GL column pass takes one '{pos}' "
                             f"operand, {variant(cp)} has {len(forms)}")
        out.append(forms[0] if forms else (C.OP_NONE, None, None))
    return tuple(out)


def _check_launch(err: int, what: str, lib) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA {what} launch failed: "
                           + lib.ntt_gl_error_string(err).decode())


def _launch(hi: torch.Tensor, lo: torch.Tensor, cp: GLColPass,
            launches: list | None = None) -> tuple:
    """cp's launches on the (B, nn, ncols) planes (colpass.launch_plan's,
    or these of them, in turn)."""
    for name, t in (("tw", cp.tw), ("wmid", cp.wmid), ("wmat", cp.wmat),
                    ("pre", cp.pre), ("post", cp.post),
                    *((f"wfac[{i}]", t) for i, t in enumerate(cp.wfac or ())),
                    *((f"rank1[{i}]", t)
                      for i, t in enumerate(cp.rank1 or ()))):
        if t is not None and t.device != hi.device:
            raise ValueError(f"gl_colpass table {name} is on {t.device}, "
                             f"input on {hi.device}")
    if not (hi.is_contiguous() and lo.is_contiguous()):
        raise ValueError("the CUDA GL column pass takes contiguous tensors")
    B, nn, c = hi.shape
    if launches is None:
        launches = C.launch_plan(cp, c, itemsize=8)
    lib = _library()
    src = hi, lo
    plane = 4 * nn * c
    for launch in launches:
        out_shape = (B, c, nn) if launch["transpose_out"] else (B, nn, c)
        oh = torch.empty(out_shape, dtype=torch.int32, device=hi.device)
        ol = torch.empty_like(oh)
        ph = launch["phase"]
        ts, offs = launch["ts"], launch["offsets"]
        if ph is None:
            k0, tw_ptr, log_a = len(cp.phases_ts[0]), cp.tw.data_ptr(), \
                C._log_a(cp)
        else:
            k0, tw_ptr, log_a = len(ts), ph.tw.data_ptr(), -1
        n = len(ts)
        ops = [C._ptr(launch["mid"]), C._ptr(launch["mat"]),
               launch["pre_form"], C._ptr(launch["pre"]),
               C._ptr(launch["pre2"]), launch["post_form"],
               C._ptr(launch["post"]), C._ptr(launch["post2"]), C.log_s(cp)]
        key, mult = launch["key"], launch["batch_mult"]
        with torch.cuda.device(hi.device):
            stream = torch.cuda.current_stream(hi.device).cuda_stream
            for b0, b1 in C.launch_batches(B, mult):
                err = lib.ntt_gl_colpass(
                    src[0].data_ptr() + b0 * plane,
                    src[1].data_ptr() + b0 * plane,
                    oh.data_ptr() + b0 * plane, ol.data_ptr() + b0 * plane,
                    (b1 - b0) * mult, launch["rows"], launch["ncols"],
                    launch["tile_cols"].bit_length() - 1,
                    int(cp.direction == "dit"), n, k0,
                    (ctypes.c_int * n)(*ts), (ctypes.c_int * n)(*offs),
                    tw_ptr, log_a, *ops, int(launch["transpose_out"]),
                    launch["tall"], launch["inner"].bit_length() - 1,
                    launch["log_hq"], launch["log_lp"], int(launch["short"]),
                    stream)
                _check_launch(err, f"GL column pass ({key})", lib)
                gl_colpass.launches += 1
                gl_colpass.launches_by[key] = (
                    gl_colpass.launches_by.get(key, 0) + 1)
        src = oh, ol
    return src


def gl_colpass(x: tuple, cp: GLColPass) -> tuple:
    """Run one Goldilocks column pass on a (hi, lo) tuple: the CUDA kernel
    for CUDA tensors (one launch per colpass.MAX_LAUNCH_BATCH batch rows; a
    tall column's two phases, each so), the plain version for CPU tensors.
    ``gl_colpass.launches`` counts kernel launches, ``gl_colpass.launches_by``
    them by instantiation (``variant``)."""
    device = _planes(x, "gl_colpass")[0].device
    if device.type == "cpu":
        return gl_colpass_plain(x, cp)
    if device.type != "cuda":
        raise ValueError(f"no GL column pass for device {device}")
    hi, lo, squeeze = _batched(x, cp)
    out = _launch(hi, lo, cp)
    return tuple(v[0] for v in out) if squeeze else out


gl_colpass.launches = 0
gl_colpass.launches_by = {}


def gl_colpass_phase(x: tuple, cp: GLColPass, phase: str) -> tuple:
    """One launch of a tall cp's route, the one whose key is variant(cp,
    phase) (``colpass.colpass_phase`` on limb planes): the kernel for CUDA
    tensors, counted as gl_colpass counts it, its plain version
    (``gl_launch_plain``) for CPU tensors."""
    if phase not in C.launch_keys(cp):
        raise ValueError(f"no phase {phase!r} of a {cp.nn}-row column pass "
                         f"(its launches: {C.launch_keys(cp)})")
    ncols = _planes(x, "gl_colpass")[0].shape[-1]
    return gl_colpass_launch(x, cp, C._launch_of(cp, ncols, phase,
                                                 itemsize=8))


def gl_colpass_launch(x: tuple, cp: GLColPass, launch: dict) -> tuple:
    """One launch of colpass.launch_plan(cp, ncols, itemsize=8, ...) on
    its input planes (colpass.colpass_launch's twin): the kernel for CUDA
    tensors, counted as gl_colpass counts it, ``gl_launch_plain`` for CPU
    tensors."""
    hi, lo, squeeze = _batched(x, cp)
    if hi.device.type == "cpu":
        out = gl_launch_plain((hi, lo), cp, launch)
    else:
        out = _launch(hi, lo, cp, [launch])
    return tuple(v[0] for v in out) if squeeze else out


def gl_mul(a: tuple, b: tuple) -> tuple:
    """Pointwise a * b mod p on (hi, lo) int32 planes: b of a's shape, or
    of its trailing shape, broadcast over a's leading axes (psi over a
    batch: the kernel takes b's index modulo its size). The CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.
    ``gl_mul.launches`` counts kernel launches."""
    ah, al, bh, bl = _mul_operands(a, b)
    if ah.device.type == "cpu":
        return gl_mul_plain(a, b)
    if ah.device.type != "cuda":
        raise ValueError(f"no GL product for device {ah.device}")
    if not all(v.is_contiguous() for v in (ah, al, bh, bl)):
        raise ValueError("the CUDA GL product takes contiguous tensors")
    oh, ol = torch.empty_like(ah), torch.empty_like(al)
    lib = _library()
    with torch.cuda.device(ah.device):
        stream = torch.cuda.current_stream(ah.device).cuda_stream
        err = lib.ntt_gl_mul(ah.data_ptr(), al.data_ptr(), bh.data_ptr(),
                             bl.data_ptr(), oh.data_ptr(), ol.data_ptr(),
                             ah.numel(), bh.numel(), stream)
    _check_launch(err, "GL product", lib)
    gl_mul.launches += 1
    return oh, ol


gl_mul.launches = 0
