"""The four-step column pass: a CUDA kernel and its plain PyTorch version.

Port of ``ntt_aie_tpu/ops/pallas_ntt.py``: the stage section
(``run_stages``/``run_col_network``) and the Pallas kernel
``build_colpass``/``make_colpass``, for the configurations the plans run
(the fold plan's ``cp1``: DIF + 'post_t' wmat + transpose_out, ``cp2``:
DIF + canonicalize, ``icp2``: DIT + 'post_t' iwmat + transpose_out,
``icp1``: DIT + canonicalize; and with the reference's 'pre' and 'post'
operands the negacyclic passes ``ncp1``/``nicp1`` and the
``wmat_fold=False`` arm, and with its factored ``wfac`` and rank-1
operands the ``wmat_factored=True`` arm, ``plan.fold_passes``; and the
distributed plan's passes, which never transpose,
``parallel.fourstep.dist_passes``), under any
``Reduction`` (harvey4, harvey, montgomery, barrett). The operands apply in
the reference's order (``pallas_ntt.py:434-470``): on load the 'pre'
matrix, the 'pre' wfac and the 'pre' rank-1 operand, the stages, then the
'post' matrix, wfac and rank-1 operand, then the transpose, 'post_t' and
canonicalize.

A column of more than LAUNCH_ROWS rows (a tall column: nn = 8,192 and
up, BabyBear's largest transforms or a pinned split; a Goldilocks column
from GL_LAUNCH_ROWS = 2,048 rows, ``route_rows``) runs on the card as the
launches of its tall route:
``make_colpass`` gives its ColPass the two phases of its nested R x S
network (``tall_phases``), and the pass runs as two launches, phase A
over the view (B, rows, inner * ncols) of the input and phase B over the
same kind of view of A's output (``csrc/colpass_tile.cuh`` Tall);
``tall_phase_plain`` is each launch's plain version. Nothing runs between
them. A phase of more than LAUNCH_ROWS rows (a column above LAUNCH_ROWS^2
= 2^24 rows) runs as two launches of its own, split by stage group
(``phase_groups``): the stages whose half size is at least Q over the
view (B, P, Q * inner * ncols), their twiddle taken by the view's column,
and the others over B * P arrays of (Q, inner * ncols). ``launch_plan``
lists a pass's launches and ``launch_plain`` is any launch's plain
version.

A column of one row (the split (1, n)) is a network of zero stages: its
pass still multiplies by its operands, transposes and canonicalizes, one
launch of an elementwise kernel (``csrc/colpass_tile.cuh``
``column_empty``). A Goldilocks column of 2 to SHORT_ROWS rows runs on a
kernel of its own, one thread a column, its values in registers
(``is_short``; ``csrc/gl_colpass.cu`` ``gl_colpass_short_kernel``).

``colpass(x, cp)`` is the entry point. On a CPU tensor it runs the plain
version, ``colpass_plain``; on a CUDA tensor it launches the kernel in
``csrc/colpass.cu`` or raises — there is no fallback. Each CUDA source
under ``csrc/`` is built with nvcc at first use into its own library in
``build/ntt_aie_tpu_torch/`` (keyed by ``library_key``: a hash of its
source, the shared ``csrc/*.cuh`` headers and the flags) and bound with
ctypes (``build_library``, ``build_libraries``). The column and fused
kernels build one library per reduction (``-DNTT_REDUCTION=<kind>``,
``csrc/reductions.cuh``), so a plan builds only the one it uses.

Tensors are ``torch.int32`` holding uint32 bit patterns: (B, nn, ncols)
in, (B, nn, ncols) out, or (B, ncols, nn) with transpose_out; a 2-D
(nn, ncols) input is a batch of one. Output domain: the reduction's
([0, 4p) harvey4, [0, 2p) harvey, [0, p) montgomery and barrett) without
canonicalize, [0, p) with it. Both versions compute the same radix-2
network with the same uint32 operations, so their outputs are equal bit
for bit, lazy values included. (The reference's Pallas DIT groups stages
with lazy subtrees, so its raw lazy bits differ under harvey4 and harvey;
canonical values agree.)
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np
import torch

from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops.reductions import Reduction, make_reduction
from ntt_aie_tpu_torch.utils.device import resolve_device

CSRC_DIR = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "ntt_aie_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
MAX_ROWS = 8192       # csrc/colpass.cu kMaxRows: the tallest tile
# The tallest 32-bit column, or phase of a tall column, that runs as one
# launch; a taller one runs as its tall route's launches (launch_plan).
# At 8,192 rows a launch's 4-column tile takes 128 KB and one block an SM
# (PERF.md section 6 gives the readings that set it).
LAUNCH_ROWS = 4096
# Goldilocks's (route_rows): at 4,096 rows its whole launch lost to the
# route in the DIT direction (2-column tiles) and at 8,192 rows in both
# (PERF.md section 6)
GL_LAUNCH_ROWS = 2048
# The tallest Goldilocks column (of more than one row) that runs on the
# register kernel, one thread a column (csrc/gl_colpass.cu
# gl_colpass_short_kernel, kShortRows), instead of a column tile whose one
# group of stages leaves most of its threads idle (PERF.md section 6)
SHORT_ROWS = 8
# 8,192 elements a tile where the column allows it: 32 KB of uint32, 64 KB
# of uint64 (at 1024 rows, 8 columns: 32 bytes a row, and a plane)
_TILE_ELEMS = 8192
_MAX_TILE_BYTES = 131072  # the widest tile: MAX_ROWS x 4 columns x 4 bytes
_MIN_TILE_COLS = 4
_MAX_TILE_COLS = 32
# The reductions the 32-bit column and fused kernels are built for, one
# library each (csrc/reductions.cuh)
REDUCTIONS = ("harvey4", "harvey", "montgomery", "barrett")
PER_REDUCTION = ("colpass", "fused_fourstep")
# The most batch rows one launch of a column kernel takes (colpass.cu,
# gl_colpass.cu and nested_colpass.cu run the batch on grid.y); the
# wrappers split a larger batch into launches of at most this many rows.
MAX_LAUNCH_BATCH = 65535


@dataclasses.dataclass(frozen=True, eq=False)
class ColPass:
    """One column pass: its static configuration and its tables, prepared
    once on the plan's device as int32 tensors.

    Every table is in the reduction's pair form (``Reduction.pair``:
    harvey4 (w, packed Shoup halves), harvey (w, w'), montgomery (w*R mod
    p, 0), barrett (w, 0)).

    tw: (2, sum(ts)) — row 0 the stage twiddles w of every stage in
      order, row 1 their second tables; offsets[s] is stage s's start.
    wmid: (2, nn) nested mid multiply, or None for a plain network.
    wmat: (ncols, nn, 2) 'post_t' operand, each pair adjacent, or None.
    pre, post: (nn, ncols, 2) 'pre' and 'post' operands, indexed like
      the input, or None.
    wfac: the factored four-step matrix (twiddles.fourstep_wfac_T), a pair
      (T1 (nn/S, ncols, 2), T2 (S, ncols, 2)): the value at row c = c1*S +
      c0 times T1[c1] and then T2[c0]; at wfac_pos, 'pre' or 'post'.
    rank1: a rank-1 operand (twiddles.negacyclic_psi_factors), a pair
      (row (nn, 2), col (ncols, 2)): the value at (r, c) times row[r] and
      then col[c]; at rank1_pos. Every operand is shared by every batch
      row.
    tw_pairs, wmid_pairs: tw and wmid with each pair adjacent,
      (sum(ts), 2) and (nn, 2) or None: the CUDA column and nested kernels
      load a pair as one 8-byte word (the fused kernel reads tw and wmid).
    tall: for nn > LAUNCH_ROWS, the two phases of the tall route
      (``tall_phases``), else None.
    """

    red: Reduction
    nn: int
    direction: str
    phases_ts: tuple
    mid_rs: tuple
    canonicalize: bool
    transpose_out: bool
    tw: torch.Tensor
    offsets: tuple
    wmid: torch.Tensor | None
    wmat: torch.Tensor | None
    tw_pairs: torch.Tensor
    wmid_pairs: torch.Tensor | None
    pre: torch.Tensor | None = None
    post: torch.Tensor | None = None
    wfac: tuple | None = None
    wfac_pos: str | None = None
    rank1: tuple | None = None
    rank1_pos: str | None = None
    tall: tuple | None = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return colpass(x, self)


@dataclasses.dataclass(frozen=True, eq=False)
class TallPhase:
    """One launch of a tall column's route: one phase of its nested
    network as a plain network of ``rows`` points down each column of the
    view (B, rows, inner * ncols) of a (B, nn, ncols) array, in which the
    other factor of nn, ``inner``, rides the columns: the view's element
    (l, j) is the array's row l * inner + j // ncols, column j % ncols.

    phase: 'A' (the network's first phase: the 'pre' operands on load,
      the mid multiply and the row move on store) or 'B' (its second, over
      A's output: the 'post' operands, the transpose, 'post_t' and
      canonicalize on store).
    ts, offsets: the phase's stage half sizes and table offsets; tw (2,
      sum(ts)) its stage twiddles in the pass's table form (a ColPass's
      pairs, or a GLColPass's (sum(ts),) values), and tw_pairs the pairs
      adjacent (None for Goldilocks).
    """

    phase: str
    rows: int
    inner: int
    ts: tuple
    offsets: tuple
    tw: torch.Tensor
    tw_pairs: torch.Tensor | None


def tall_phases(cp) -> tuple:
    """The two TallPhases of a nested column pass cp (a ColPass or a
    gl_colpass.GLColPass): the tall network's own phases, each of its
    stages' twiddles taken every inner-th (twiddles.col_network repeats
    each phase's vectors by the other factor, so that a stage of half size
    t * inner pairs the view's rows t apart)."""
    if cp.wmid is None:
        raise ValueError(f"a {cp.nn}-row column pass is a plain network; "
                         "only a nested one has phases")
    out, k = [], 0
    for phase, ts in zip("AB", cp.phases_ts):
        rows = 1 << len(ts)
        inner = cp.nn // rows
        if any(t % inner for t in ts):
            raise ValueError(f"phase {phase}'s stages {ts} do not carry "
                             f"{inner} columns")
        tabs = [cp.tw[..., off:off + t:inner]
                for t, off in zip(ts, cp.offsets[k:k + len(ts)])]
        k += len(ts)
        ts_p = tuple(t // inner for t in ts)
        tw_p = torch.cat(tabs, dim=-1).contiguous()
        out.append(TallPhase(
            phase=phase, rows=rows, inner=inner, ts=ts_p,
            offsets=tuple(int(o) for o in np.cumsum((0,) + ts_p[:-1])),
            tw=tw_p, tw_pairs=tw_p.t().contiguous() if tw_p.dim() == 2
            else None))
    return tuple(out)


def _u32_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device)


def _pair(w, w2, device) -> torch.Tensor:
    return torch.stack([_u32_tensor(w, device), _u32_tensor(w2, device)])


def _pack(wh, wl) -> np.ndarray:
    wh = np.asarray(wh).astype(np.uint32)
    wl = np.asarray(wl).astype(np.uint32)
    return (wh << np.uint32(16)) | wl


POSITIONS = ("pre", "post", "post_t")
FACTOR_POSITIONS = ("pre", "post")


def _present(slots):
    """The (table, position) slots that hold a table, each position
    checked."""
    for tab, pos in slots:
        if tab is None:
            continue
        if pos not in POSITIONS:
            raise ValueError(f"twiddle position must be one of {POSITIONS}, "
                             f"got {pos!r}")
        yield tab, pos


def check_factors(kind: str, pos: str, a: tuple, b: tuple, nn: int):
    """Raise ValueError unless a factored ('wfac') or rank-1 ('rank1')
    operand at pos over nn rows has tables of shapes a and b (values, no
    pair axis): wfac (nn/S, ncols) and (S, ncols) of a power of two
    S < nn, rank1 (nn,) and (ncols,)."""
    if pos not in FACTOR_POSITIONS:
        raise ValueError(f"{kind}_pos must be one of {FACTOR_POSITIONS}, "
                         f"got {pos!r}")
    if kind == "wfac":
        s = b[0] if b else 0
        if not (len(a) == len(b) == 2 and a[1] == b[1] and 0 < s < nn
                and a[0] * s == nn and not s & (s - 1)):
            raise ValueError(f"wfac tables {a} and {b} are not (nn/S, "
                             f"ncols) and (S, ncols) of a power of two "
                             f"S < {nn}")
    elif len(a) != 1 or len(b) != 1 or a[0] != nn:
        raise ValueError(f"rank1 vectors {a} and {b} are not ({nn},) and "
                         "(ncols,)")


def _factor_tensors(kind, pos, tabs, nn, device):
    """The device pair tensors of a factored ('wfac') or rank-1 ('rank1')
    operand: tabs holds its two tables, each a (w, w2) pair of host
    arrays."""
    a, b = (_pair(t[0], t[1], device).movedim(0, -1).contiguous()
            for t in tabs)
    check_factors(kind, pos, tuple(a.shape[:-1]), tuple(b.shape[:-1]), nn)
    return a, b


def stage_offsets(ts) -> tuple:
    """Each stage's start in the concatenated stage tables (an empty
    network, a one-row column's, has none)."""
    return tuple(int(o) for o in np.cumsum([0] + list(ts[:-1])))[:len(ts)]


def _assemble(red, nn, direction, phases_ts, mid_rs, stage_tabs, mid_tab,
              operands, canonicalize, transpose_out, device,
              factors=None) -> ColPass:
    """stage_tabs: per stage a (w, w2) pair of host arrays
    (``Reduction.pair``); mid_tab: a pair or None; operands: {position:
    pair}, 'pre' and 'post' of shape (nn, ncols), 'post_t' of shape
    (ncols, nn); factors: {'wfac' or 'rank1': (position, (pair, pair))}."""
    factors = factors or {}
    if direction not in ("dif", "dit"):
        raise ValueError(f"direction must be 'dif' or 'dit', got {direction!r}")
    if "post_t" in operands and not transpose_out:
        raise ValueError("the 'post_t' multiply needs transpose_out=True")
    ts = [t for ph in phases_ts for t in ph]
    if (1 << len(ts)) != nn or len(stage_tabs) != len(ts):
        raise ValueError(f"stage list {phases_ts} does not cover {nn} rows")
    if (len(phases_ts) == 2) != (mid_tab is not None):
        raise ValueError("a nested network needs exactly two phases and wmid")
    tabs = (list(stage_tabs) + ([mid_tab] if mid_tab is not None else [])
            + list(operands.values()))
    if any(len(t) != 2 for t in tabs):
        raise ValueError("every table is a (w, w2) pair (Reduction.pair)")
    offsets = stage_offsets(ts)
    w_all = np.concatenate([np.ravel(tab[0]) for tab in stage_tabs]
                           or [np.zeros(0, np.uint32)])
    s_all = np.concatenate([np.ravel(tab[1]) for tab in stage_tabs]
                           or [np.zeros(0, np.uint32)])
    wmid = None
    if mid_tab is not None:
        wmid = _pair(np.ravel(mid_tab[0]), np.ravel(mid_tab[1]), device)
    mats = {}
    for pos, tab in operands.items():
        mat = _pair(tab[0], tab[1], device).movedim(0, -1).contiguous()
        rows = mat.shape[1] if pos == "post_t" else mat.shape[0]
        if mat.dim() != 3 or rows != nn:
            want = f"(ncols, {nn})" if pos == "post_t" else f"({nn}, ncols)"
            raise ValueError(f"{pos} operand {tuple(mat.shape[:-1])} is not "
                             f"{want}")
        mats[pos] = mat
    fac = {kind: (pos, _factor_tensors(kind, pos, tabs, nn, device))
           for kind, (pos, tabs) in factors.items()}
    wfac_pos, wfac = fac.get("wfac", (None, None))
    rank1_pos, rank1 = fac.get("rank1", (None, None))
    tw = _pair(w_all, s_all, device)
    cp = ColPass(red=red, nn=nn, direction=direction,
                 phases_ts=tuple(tuple(int(t) for t in ph)
                                 for ph in phases_ts),
                 mid_rs=tuple(int(v) for v in mid_rs),
                 canonicalize=canonicalize, transpose_out=transpose_out,
                 tw=tw, offsets=offsets, wmid=wmid,
                 wmat=mats.get("post_t"),
                 tw_pairs=tw.t().contiguous(),
                 wmid_pairs=None if wmid is None else wmid.t().contiguous(),
                 pre=mats.get("pre"), post=mats.get("post"),
                 wfac=wfac, wfac_pos=wfac_pos, rank1=rank1,
                 rank1_pos=rank1_pos)
    if nn > LAUNCH_ROWS:
        cp = dataclasses.replace(cp, tall=tall_phases(cp))
    return cp


def make_colpass(field, nn: int, *, direction: str, inverse_tw: bool = False,
                 wmat: np.ndarray | None = None, twiddle_pos: str = "post_t",
                 wmat2: np.ndarray | None = None,
                 twiddle_pos2: str | None = None,
                 canonicalize: bool = False, transpose_out: bool = False,
                 reduction: str = "harvey4",
                 wfac: tuple | None = None, wfac_pos: str | None = None,
                 rank1: tuple | None = None, rank1_pos: str | None = None,
                 device=None) -> ColPass:
    """Build a column pass for nn-point columns from the port's own
    twiddles.col_network, under the reduction of this kind.

    wmat, wmat2: host operands of canonical values, applied at
    twiddle_pos and twiddle_pos2, each 'pre' (on load), 'post' (after the
    stages, before the transpose) or 'post_t' (after the transpose): an
    (nn, ncols) table, or (ncols, nn) for 'post_t' (the output's
    orientation). twiddle_pos is 'post_t' unless given (the fold plan's
    four-step matrix); wmat2 needs its position. Two operands at one
    position are multiplied into one table mod p: the canonical outputs
    are those of the two multiplies in turn.

    wfac: (T1 (nn/S, ncols), T2 (S, ncols)) host tables of
    twiddles.fourstep_wfac_T, the factored four-step matrix, applied at
    wfac_pos ('pre' or 'post') as two multiplies; rank1: (row (nn,), col
    (ncols,)) host vectors of twiddles.negacyclic_psi_factors, applied at
    rank1_pos as two multiplies (the reference's make_colpass wfac= and
    rank1=). device: None is the card (utils.device.resolve_device)."""
    device = resolve_device(device)
    red = make_reduction(reduction, field)
    net = tw.col_network(field, nn, direction=direction, inverse=inverse_tw)
    stage_tabs = [red.pair(v) for ph in net["phases"] for v in ph["vecs"]]
    mid_tab = (red.pair(net["mid"]["wmid"])
               if net["mid"] is not None else None)
    if wmat2 is not None and twiddle_pos2 is None:
        raise ValueError("wmat2 needs twiddle_pos2")
    tables = {}
    for tab, pos in _present(((wmat, twiddle_pos), (wmat2, twiddle_pos2))):
        if pos in tables:  # one table: the values' product mod p (< 2^62)
            tab = (np.asarray(tables[pos]).astype(np.uint64)
                   * np.asarray(tab).astype(np.uint64) % np.uint64(red.p))
        tables[pos] = tab
    operands = {pos: red.pair(tab) for pos, tab in tables.items()}
    factors = {}
    for kind, tabs, pos in (("wfac", wfac, wfac_pos),
                            ("rank1", rank1, rank1_pos)):
        if tabs is not None:
            factors[kind] = (pos, tuple(red.pair(t) for t in tabs))
    return _assemble(red, nn, direction,
                     [ph["ts"] for ph in net["phases"]], (net["R"], net["S"]),
                     stage_tabs, mid_tab, operands, canonicalize,
                     transpose_out, device, factors)


def colpass_from_reference(arrays: dict, *, field, direction: str,
                           phases_ts, mid_rs, canonicalize: bool = False,
                           transpose_out: bool = False,
                           twiddle_pos: str = "post_t",
                           twiddle_pos2: str | None = None,
                           device=None) -> ColPass:
    """Build a column pass from the reference Pallas colpass's own
    operands: arrays["tw_cols"] is ``PallasColpass.tw_cols`` as NumPy
    arrays (per stage (w, wh, wl), then the nested wmid's three), and
    arrays["wmat"] and arrays["wmat2"] its ``.wmat`` and ``.wmat2`` pairs
    (w, packed) or None, at twiddle_pos and twiddle_pos2 (two positions)
    as the reference pass was built; harvey4, as the reference plan's
    tables for p < 2^29 are. device: None is the card."""
    device = resolve_device(device)
    red = make_reduction("harvey4", field)
    cols = list(arrays["tw_cols"])
    nt = red.n_tables
    nstages = sum(len(ph) for ph in phases_ts)

    def pair(w, wh, wl):
        return (np.asarray(w), _pack(wh, wl))

    stage_tabs = [pair(*cols[s * nt:(s + 1) * nt]) for s in range(nstages)]
    rest = cols[nstages * nt:]
    mid_tab = pair(*rest) if rest else None
    slots = list(_present(((arrays.get("wmat"), twiddle_pos),
                           (arrays.get("wmat2"), twiddle_pos2))))
    operands = {pos: tuple(np.asarray(t) for t in tab) for tab, pos in slots}
    if len(operands) < len(slots):
        raise ValueError("the reference pass's two operands are at one "
                         "position")
    return _assemble(red, 1 << nstages, direction, phases_ts, mid_rs,
                     stage_tabs, mid_tab, operands, canonicalize,
                     transpose_out, device)


# ---- plain PyTorch version -------------------------------------------------

def _batched(x: torch.Tensor, cp: ColPass):
    if x.dtype != torch.int32:
        raise TypeError(f"colpass takes int32 tensors, got {x.dtype}")
    squeeze = x.dim() == 2
    xb = x.unsqueeze(0) if squeeze else x
    if xb.dim() != 3 or xb.shape[1] != cp.nn:
        raise ValueError(f"colpass over {cp.nn} rows takes (B, {cp.nn}, "
                         f"ncols) or ({cp.nn}, ncols), got {tuple(x.shape)}")
    for pos, cols in (("post_t", None if cp.wmat is None else
                       cp.wmat.shape[0]),
                      ("pre", None if cp.pre is None else cp.pre.shape[1]),
                      ("post", None if cp.post is None else cp.post.shape[1]),
                      ("wfac", None if cp.wfac is None else
                       cp.wfac[0].shape[1]),
                      ("rank1", None if cp.rank1 is None else
                       cp.rank1[1].shape[0])):
        if cols is not None and cols != xb.shape[2]:
            raise ValueError(f"{pos} operand has {cols} columns, input has "
                             f"{xb.shape[2]}")
    return xb, squeeze


def _run_stages(x, w, s, ts, offsets, direction, red):
    """Radix-2 butterfly stages over axis 1 of a (B, nn, c) carrier."""
    B, nn, c = x.shape
    subm = red.sub_for_mul or red.sub
    for t, off in zip(ts, offsets):
        xv = x.reshape(B, nn // (2 * t), 2, t, c)
        u, v = xv[:, :, 0], xv[:, :, 1]
        wv = w[off:off + t].view(1, 1, t, 1)
        sv = s[off:off + t].view(1, 1, t, 1)
        if direction == "dif":
            hi = red.add(u, v)
            lo = red.mulc_mat(subm(u, v), wv, sv)
        else:
            prod = red.mulc_mat(v, wv, sv)
            hi = red.add(u, prod)
            lo = red.sub(u, prod)
        x = torch.stack((hi, lo), dim=2).reshape(B, nn, c)
    return x


def _mid_move(v: torch.Tensor, cp: ColPass) -> torch.Tensor:
    """The nested network's mid step on a (B, nn, c) carrier: DIF
    multiplies by wmid, then moves the row at r*S + s to s*R + r; DIT
    makes the inverse move, then multiplies."""
    red = cp.red
    B, nn, c = v.shape
    R, S = cp.mid_rs
    mw = M.to_carrier(cp.wmid[0]).view(1, nn, 1)
    ms = M.to_carrier(cp.wmid[1]).view(1, nn, 1)
    if cp.direction == "dif":
        v = red.mulc_mat(v, mw, ms)
        return v.view(B, R, S, c).transpose(1, 2).reshape(B, nn, c)
    v = v.view(B, S, R, c).transpose(1, 2).reshape(B, nn, c)
    return red.mulc_mat(v, mw, ms)


def run_network(v: torch.Tensor, cp: ColPass) -> torch.Tensor:
    """Every stage of cp's column network (plain, or nested with its mid
    step and row move) down axis 1 of a (B, nn, c) int64 carrier."""
    red = cp.red
    w, s = M.to_carrier(cp.tw[0]), M.to_carrier(cp.tw[1])
    k0 = len(cp.phases_ts[0])
    v = _run_stages(v, w, s, cp.phases_ts[0], cp.offsets[:k0],
                    cp.direction, red)
    if cp.wmid is not None:
        v = _mid_move(v, cp)
        v = _run_stages(v, w, s, cp.phases_ts[1], cp.offsets[k0:],
                        cp.direction, red)
    return v


def _mul_operand(v: torch.Tensor, mat: torch.Tensor, red) -> torch.Tensor:
    return red.mulc_mat(v, M.to_carrier(mat[..., 0]),
                        M.to_carrier(mat[..., 1]))


def mul_wfac(v: torch.Tensor, wfac: tuple, red) -> torch.Tensor:
    """v (B, rows, c) times the factored matrix: T1[c1] broadcast over c0,
    then T2[c0] broadcast over c1, for row c1*S + c0 (the reference's
    apply_wfac_arrays)."""
    t1, t2 = wfac
    B, rr, cc = v.shape
    s = t2.shape[0]
    v = v.reshape(B, rr // s, s, cc)
    v = _mul_operand(v, t1.view(1, rr // s, 1, cc, 2), red)
    v = _mul_operand(v, t2.view(1, 1, s, cc, 2), red)
    return v.reshape(B, rr, cc)


def mul_rank1(v: torch.Tensor, rank1: tuple, red) -> torch.Tensor:
    """v (B, rows, c) times row[r] broadcast over the columns, then
    col[c] broadcast over the rows (the reference's apply_rank1)."""
    row, col = rank1
    v = _mul_operand(v, row.view(1, -1, 1, 2), red)
    return _mul_operand(v, col.view(1, 1, -1, 2), red)


def _mul_at(v: torch.Tensor, cp: ColPass, pos: str) -> torch.Tensor:
    """v times cp's operands at 'pre' or 'post', in the reference's
    order: the matrix, wfac, rank-1."""
    red = cp.red
    mat = cp.pre if pos == "pre" else cp.post
    if mat is not None:
        v = _mul_operand(v, mat, red)
    if cp.wfac is not None and cp.wfac_pos == pos:
        v = mul_wfac(v, cp.wfac, red)
    if cp.rank1 is not None and cp.rank1_pos == pos:
        v = mul_rank1(v, cp.rank1, red)
    return v


def _store_ops(v: torch.Tensor, cp: ColPass) -> torch.Tensor:
    """What follows the network: the 'post' operands, the transpose and
    'post_t', canonicalize."""
    red = cp.red
    v = _mul_at(v, cp, "post")
    if cp.transpose_out:
        v = v.transpose(1, 2)
        if cp.wmat is not None:
            v = _mul_operand(v, cp.wmat, red)
    if cp.canonicalize:
        v = red.canonicalize(v)
    return v


def colpass_plain(x: torch.Tensor, cp: ColPass) -> torch.Tensor:
    """The column pass in plain PyTorch ops (int64 carriers), on any
    device: the oracle the kernel is held against. The reference's order:
    the 'pre' operands, the network, the 'post' operands, then the
    transpose and 'post_t', then canonicalize."""
    xb, squeeze = _batched(x, cp)
    v = _mul_at(M.to_carrier(xb), cp, "pre")
    v = _store_ops(run_network(v, cp), cp)
    out = M.from_carrier(v).contiguous()
    return out[0] if squeeze else out


def tall_phase_plain(x: torch.Tensor, cp: ColPass,
                     phase: str) -> torch.Tensor:
    """One launch of cp's tall route in plain PyTorch ops: phase 'A'
    takes the (B, nn, ncols) input to the moved array, (B, nn, ncols) of
    the same layout (the 'pre' operands, phase 0 over the view (B, rows,
    inner * ncols), the mid multiply and the row move); phase 'B' takes
    that array to the pass's output (phase 1 over its view, then the
    'post' operands, the transpose and 'post_t', canonicalize). B's of
    A's output is colpass_plain's output bit for bit. cp: a nested pass of
    any height (its tall_phases where it has no tall route)."""
    ph = (cp.tall or tall_phases(cp))["AB".index(phase)]
    return _phase_plain(x, cp, ph, (0, len(ph.ts)), pre=phase == "A",
                        mid=phase == "A", store=phase == "B")


def _phase_plain(x, cp, ph, stages, *, pre, mid, store):
    """Stages s0 .. s1 - 1 of tall phase ph over its view (B, rows, inner
    * ncols) of x, in plain PyTorch ops: the 'pre' operands first where
    pre, then the mid step where mid, or the store operations where store
    (tall_phase_plain's and launch_plain's)."""
    xb, squeeze = _batched(x, cp)
    s0, s1 = stages
    B, nn, c = xb.shape
    v = M.to_carrier(xb)
    if pre:
        v = _mul_at(v, cp, "pre")
    v = _run_stages(v.reshape(B, ph.rows, ph.inner * c),
                    M.to_carrier(ph.tw[0]), M.to_carrier(ph.tw[1]),
                    ph.ts[s0:s1], ph.offsets[s0:s1], cp.direction,
                    cp.red).reshape(B, nn, c)
    if mid:
        v = _mid_move(v, cp)
    elif store:
        v = _store_ops(v, cp)
    out = M.from_carrier(v).contiguous()
    return out[0] if squeeze else out


# ---- CUDA kernel -----------------------------------------------------------

def tile_cols(nn: int, ncols: int, itemsize: int = 4) -> int:
    """Columns per thread block (TL): a tile of nn x TL elements of
    `itemsize` bytes holds 8,192 elements (32 KB of uint32, 64 KB of
    uint64) where 4 <= TL <= 32 allows (small tiles keep more blocks per
    SM; at 1024 rows both widths take TL = 8, whole 32-byte sectors a row
    of each uint32 plane). The tallest column is MAX_ROWS rows: its
    4-column tile takes 128 KB at uint32; at uint64, where a 4-column tile
    of more than 4096 rows would pass 128 KB, the tile is 2 columns
    wide."""
    if nn > MAX_ROWS:
        raise ValueError(f"the CUDA column pass takes at most {MAX_ROWS} "
                         f"rows of {itemsize}-byte values, got {nn}")
    if ncols & (ncols - 1):
        raise ValueError(f"ncols must be a power of two, got {ncols}")
    min_cols = _MIN_TILE_COLS
    if nn * min_cols * itemsize > _MAX_TILE_BYTES:
        min_cols = 2
    return min(_MAX_TILE_COLS, ncols,
               max(min_cols, _TILE_ELEMS // nn))


def tile_shift(cp: ColPass, log_tl: int) -> int:
    """The shift s of cp's tile of 2^log_tl columns in the kernel's
    swizzled layout (``csrc/colpass_tile.cuh`` tile_shift): log2(nn / A)
    for a nested network whose row map is A (R for DIF, S for DIT), log2 nn
    for a plain one, and at least 5 - log_tl."""
    log_a = _log_a(cp)
    s = cp.nn.bit_length() - 1 - (log_a if log_a >= 0 else 0)
    return max(5 - log_tl, s)


def tile_address(row, c, log_tl: int, shift: int):
    """The shared-memory word of physical row ``row``, column ``c`` of a
    column tile of 2^log_tl <= 32 columns in the kernel's swizzled layout
    (``csrc/colpass_tile.cuh`` word_of), on NumPy integer arrays or ints:
    the tile's 32-word lines hold 2^b = 32 / TL rows, and row r takes slot
    (r XOR (r >> shift)) mod 2^b of its line (``tile_shift``)."""
    b = 5 - log_tl
    if not 0 <= b <= 5 or shift < b:
        raise ValueError(f"no swizzled tile of 2^{log_tl} columns with "
                         f"shift {shift}")
    row = np.asarray(row, dtype=np.int64)
    slot = (row ^ (row >> shift)) & ((1 << b) - 1)
    return ((((row >> b) << b) | slot) << log_tl) | np.asarray(c, np.int64)


def _nvcc_flags(name: str, reduction: str) -> tuple:
    """nvcc's flags for csrc/<name>.cu: NVCC_FLAGS, and for the sources
    built once per reduction (PER_REDUCTION) the reduction's macro."""
    if name not in PER_REDUCTION:
        return NVCC_FLAGS
    if reduction not in REDUCTIONS:
        raise ValueError(f"csrc/{name}.cu is built for {REDUCTIONS}, not "
                         f"{reduction!r}")
    return NVCC_FLAGS + (f"-DNTT_REDUCTION={reduction}",)


def library_key(name: str, csrc_dir: pathlib.Path = CSRC_DIR,
                reduction: str = "harvey4") -> str:
    """The build key of csrc/<name>.cu (for the sources in PER_REDUCTION,
    under this reduction): a hash of its source, of every csrc/*.cuh
    header (so a header edit rebuilds every library) and of the nvcc
    flags, the reduction's macro included."""
    h = hashlib.sha256((csrc_dir / f"{name}.cu").read_bytes())
    for header in sorted(csrc_dir.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(_nvcc_flags(name, reduction)).encode())
    return h.hexdigest()[:16]


def build_library(name: str = "colpass",
                  reduction: str = "harvey4") -> pathlib.Path:
    """Compile csrc/<name>.cu with nvcc (if not built yet) and return the
    shared library's path; a source in PER_REDUCTION is built for this
    reduction (another reduction is another library). The file name
    carries library_key; the library is written under a temporary name and
    renamed, so processes building it at once never load a partial
    file."""
    src_path = CSRC_DIR / f"{name}.cu"
    flags = _nvcc_flags(name, reduction)
    stem = f"{name}-{reduction}" if name in PER_REDUCTION else name
    so = BUILD_DIR / f"{stem}-{library_key(name, reduction=reduction)}.so"
    if so.exists():
        return so
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
            else shutil.which("nvcc"))
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: csrc/{name}.cu cannot be built "
                           "(set CUDA_HOME)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    res = subprocess.run([nvcc, *flags, "-o", str(tmp), str(src_path)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src_path} ({' '.join(flags)}):"
                           f"\n{res.stderr}")
    os.replace(tmp, so)
    return so


def start_builds() -> dict:
    """Start building every csrc/*.cu at once, the sources in
    PER_REDUCTION once per reduction, one nvcc process each, and return
    at once: {name: future of its library path}, the per-reduction ones
    named "<name>[<reduction>]". Wait for a library's future before its
    first use: build_library called meanwhile for the same library would
    run a second nvcc into the same temporary file."""
    jobs = {}
    for name in sorted(p.stem for p in CSRC_DIR.glob("*.cu")):
        if name in PER_REDUCTION:
            jobs.update({f"{name}[{r}]": (name, r) for r in REDUCTIONS})
        else:
            jobs[name] = (name, "harvey4")
    pool = concurrent.futures.ThreadPoolExecutor(len(jobs))
    futures = {key: pool.submit(build_library, *job)
               for key, job in jobs.items()}
    pool.shutdown(wait=False)
    return futures


def build_libraries() -> dict:
    """Build every csrc/*.cu at once (start_builds) and wait: {name:
    library path}. Raises the first build's failure."""
    return {key: f.result() for key, f in start_builds().items()}


@functools.cache
def _library(reduction: str = "harvey4") -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library("colpass", reduction)))
    vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    pi = ctypes.POINTER(ctypes.c_int)
    lib.ntt_colpass.restype = ci
    lib.ntt_colpass.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, ci, pi, pi,
                                vp, ci, vp, vp, ci, vp, vp, ci, vp, vp, ci,
                                ci, ci, ci, ci, ci, ci, cu, cu, cu, vp]
    lib.ntt_colpass_error_string.restype = ctypes.c_char_p
    lib.ntt_colpass_error_string.argtypes = [ci]
    lib.ntt_colpass_max_rows.restype = ci
    lib.ntt_colpass_kernel_info.restype = ci
    lib.ntt_colpass_kernel_info.argtypes = [ci] * 9 + [pi] * 3
    lib.ntt_reduction_name.restype = ctypes.c_char_p
    if lib.ntt_colpass_max_rows() != MAX_ROWS:
        raise RuntimeError("csrc/colpass.cu kMaxRows disagrees with MAX_ROWS")
    if lib.ntt_reduction_name().decode() != reduction:
        raise RuntimeError(f"the {reduction} column-pass library was built "
                           f"for {lib.ntt_reduction_name().decode()}")
    return lib


def kernel_info(cp: ColPass, ncols: int) -> dict:
    """What the card gives cp's kernel over (.., cp.nn, ncols), in the
    library of cp's reduction: the build's register group size (kfuse),
    the tile width TL, its layout and shift (``tile_shift``), and the
    kernel's registers a thread and co-resident blocks per SM. A tall cp
    reports each of its two launches under "phases" (``launch_plan``)."""
    lib = _library(cp.red.name)
    return launch_info(cp, ncols, lib.ntt_colpass_kernel_info,
                       lib.ntt_colpass_error_string)


def launch_info(cp, ncols: int, query, error_string, *,
                itemsize: int = 4) -> dict:
    """kernel_info of a ColPass or a GLColPass from its library's
    kernel-info query and error-string functions (the Goldilocks query
    takes a launch's "short" first)."""
    infos = []
    for launch in launch_plan(cp, ncols, itemsize=itemsize):
        log_tl = launch["tile_cols"].bit_length() - 1
        kfuse, regs, per_sm = (ctypes.c_int() for _ in range(3))
        first = [int(launch["short"])] if itemsize == 8 else []
        with torch.cuda.device(cp.tw.device):
            # a split phase's launch: 1 + log2 of the tall array's columns
            # (the kernel picks the 'lo' phase A's staged store by them)
            group = (ncols.bit_length() if launch["log_hq"] or launch["log_lp"]
                     else 0)
            err = query(*first, launch["tall"], group,
                        int(cp.direction == "dit"),
                        int(launch["transpose_out"]),
                        int(launch["mat"] is not None), launch["pre_form"],
                        launch["post_form"], launch["rows"], log_tl, kfuse,
                        regs, per_sm)
        if err != 0:
            raise RuntimeError(f"CUDA column pass occupancy query failed "
                               f"({launch['key']}): "
                               + error_string(err).decode())
        infos.append({"variant": launch["key"], "kfuse": kfuse.value,
                      "tile_cols": launch["tile_cols"],
                      "layout": "registers" if launch["short"]
                      else "swizzled", "rows": launch["rows"],
                      "shift": launch["shift"], "registers": regs.value,
                      "blocks_per_sm": per_sm.value})
    if cp.tall is None:
        return infos[0]
    return {"variant": variant(cp), "phases": infos}


def variant(cp, phase: str | None = None) -> str:
    """The kernel instantiation cp (a ColPass or a gl_colpass.GLColPass)
    launches, by its direction and operands, e.g. 'dif+pre+post_t+T' or
    'dit+wfac_post+T'
    (T: transpose_out): ``colpass.launches_by``'s and
    ``gl_colpass.launches_by``'s key. phase 'A' or 'B' (or, of a split
    phase, 'A1', 'A2', 'B1', 'B2': ``launch_keys``): the key of that
    launch of a tall cp's route, the pass's own with '+tallA' (and so
    on)."""
    parts = [cp.direction]
    for pos in FACTOR_POSITIONS:
        mat = cp.pre if pos == "pre" else cp.post
        parts += [name for name, present in (
            (pos, mat is not None),
            (f"wfac_{pos}", cp.wfac is not None and cp.wfac_pos == pos),
            (f"rank1_{pos}", cp.rank1 is not None and cp.rank1_pos == pos))
            if present]
    if cp.wmat is not None:
        parts.append("post_t")
    parts += ["T"] if cp.transpose_out else []
    return "+".join(parts + ([f"tall{phase}"] if phase else []))


# csrc/colpass_tile.cuh Operand: the form of a 'pre' or 'post' operand
OP_NONE, OP_MAT, OP_FAC, OP_RANK1 = range(4)


def _operand_forms(cp: ColPass) -> tuple:
    """(form, table, second table) of cp's 'pre' and of its 'post'
    operand, as the kernel takes them: one form a position (the kernel
    runs one), else ValueError."""
    out = []
    for pos in FACTOR_POSITIONS:
        mat = cp.pre if pos == "pre" else cp.post
        forms = [(OP_MAT, mat, None)] if mat is not None else []
        if cp.wfac is not None and cp.wfac_pos == pos:
            forms.append((OP_FAC, *cp.wfac))
        if cp.rank1 is not None and cp.rank1_pos == pos:
            forms.append((OP_RANK1, *cp.rank1))
        if len(forms) > 1:
            raise ValueError(f"the CUDA column pass takes one '{pos}' "
                             f"operand, {variant(cp)} has {len(forms)}")
        out.append(forms[0] if forms else (OP_NONE, None, None))
    return tuple(out)


def log_s(cp) -> int:
    """log2 of cp's wfac split S (a ColPass or a GLColPass), 0 without
    wfac."""
    return 0 if cp.wfac is None else cp.wfac[1].shape[0].bit_length() - 1


def _log_a(cp: ColPass) -> int:
    """log2 of the nested row map's A (R for DIF, S for DIT), -1 plain."""
    if cp.wmid is None:
        return -1
    R, S = cp.mid_rs
    return (R if cp.direction == "dif" else S).bit_length() - 1


def _stage_args(cp: ColPass) -> list:
    """nstages, k0, ts, offs of cp's stage list as C arrays."""
    ts = [t for ph in cp.phases_ts for t in ph]
    n = len(ts)
    return [n, len(cp.phases_ts[0]), (ctypes.c_int * n)(*ts),
            (ctypes.c_int * n)(*cp.offsets)]


def network_args(cp: ColPass) -> list:
    """cp's column network as the fused launcher takes it:
    nstages, k0, ts, offs, tw_w, tw_s, log_a, mid_w, mid_s (log_a = -1 and
    null mids for a plain network)."""
    mid = ([cp.wmid[0].data_ptr(), cp.wmid[1].data_ptr()]
           if cp.wmid is not None else [None, None])
    return [*_stage_args(cp), cp.tw[0].data_ptr(), cp.tw[1].data_ptr(),
            _log_a(cp), *mid]


# csrc/colpass_tile.cuh Tall: one launch of a whole column; a phase's
# launch that loads with its 'pre' operands and stores the mid multiply and
# the row move (A), or stores with the pass's store operations or in place
# (B); a split phase A's first launch, 'pre' on load and stored in place
# (PRE)
TALL_WHOLE, TALL_A, TALL_B, TALL_PRE = range(4)


def tall_shape(nn: int, direction: str) -> tuple:
    """((rows, inner) of phase A, (rows, inner) of phase B) of a tall
    column of nn rows, from the shape of its nested network alone
    (twiddles.nested_col_split: R = 2^floor(log2(nn) / 2) rows in the DIF
    network's phase 0, S = nn / R in the DIT network's)."""
    R = tw.nested_col_split(nn)
    S = nn // R
    a, b = (R, S) if direction == "dif" else (S, R)
    return (a, nn // a), (b, nn // b)


def route_rows(itemsize: int = 4) -> int:
    """The tallest column or phase one launch runs, by value width:
    LAUNCH_ROWS for uint32, GL_LAUNCH_ROWS for Goldilocks's uint64."""
    return LAUNCH_ROWS if itemsize == 4 else GL_LAUNCH_ROWS


def is_short(nn: int, itemsize: int = 4) -> bool:
    """Whether a whole column of nn rows of `itemsize`-byte values runs on
    the short kernel: a Goldilocks column of 2 to SHORT_ROWS rows."""
    return itemsize == 8 and 1 < nn <= SHORT_ROWS


def phase_groups(rows: int, direction: str,
                 max_rows: int = LAUNCH_ROWS) -> list:
    """The launches of one tall phase, a plain network of `rows` points:
    [(group, s0, s1, log_p, log_q)], stages s0 .. s1 - 1 of the phase
    each. A phase of at most max_rows rows is one launch (group None,
    every stage). A taller one, rows = P * Q (P = 2^floor(log2(rows) / 2),
    Q = rows / P, both at most max_rows for rows up to max_rows^2), is two:
    'hi', the stages of half size t >= Q, which pair rows p * Q + q that
    share q, a P-row network over the view (B, P, Q * cols) with the
    twiddle of (p, view column j) at t's table offset + (p mod t / Q) * Q +
    j / cols; and 'lo', the stages t < Q, a Q-row network over B * P
    arrays (Q, cols) with the ordinary tables. DIF runs hi then lo, DIT lo
    then hi."""
    log_r = rows.bit_length() - 1
    if rows <= max_rows:
        return [(None, 0, log_r, 0, log_r)]
    log_p = log_r // 2
    log_q = log_r - log_p
    if (1 << log_p) > max_rows or (1 << log_q) > max_rows:
        raise ValueError(f"a {rows}-row phase does not split into launches "
                         f"of at most {max_rows} rows")
    if direction == "dif":  # ts = rows/2 .. 1: the first log_p are >= Q
        return [("hi", 0, log_p, log_p, log_q),
                ("lo", log_p, log_r, log_p, log_q)]
    return [("lo", 0, log_q, log_p, log_q),  # ts = 1 .. rows/2
            ("hi", log_q, log_r, log_p, log_q)]


def launch_shapes(nn: int, ncols: int, direction: str, *, itemsize: int = 4,
                  max_rows: int | None = None) -> list:
    """[(rows, ncols, batch multiple, tile columns)] of each launch of a
    pass over (.., nn, ncols), from the shapes alone (``launch_plan``'s
    launches, without building a pass): a column of at most
    route_rows(itemsize) rows is one launch (a short one's tile columns
    1: a column a thread), a taller one its phases' groups
    (``phase_groups`` at max_rows, by default the same limit). Raises
    ValueError for a non-power-of-two side."""
    for what, v in (("nn", nn), ("ncols", ncols)):
        if v < 1 or v & (v - 1):
            raise ValueError(f"{what} must be a power of two, got {v}")
    if max_rows is None:
        max_rows = route_rows(itemsize)
    if is_short(nn, itemsize):
        return [(nn, ncols, 1, 1)]
    if nn <= route_rows(itemsize):
        return [(nn, ncols, 1, tile_cols(nn, ncols, itemsize))]
    out = []
    for rows, inner in tall_shape(nn, direction):
        for group, _, _, log_p, log_q in phase_groups(rows, direction,
                                                      max_rows):
            r, c, mult = rows, inner * ncols, 1
            if group == "hi":
                r, c = 1 << log_p, (inner * ncols) << log_q
            elif group == "lo":
                r, mult = 1 << log_q, 1 << log_p
            out.append((r, c, mult, tile_cols(r, c, itemsize)))
    return out


def launch_plan(cp, ncols: int, *, itemsize: int = 4,
                max_rows: int | None = None) -> list:
    """The launches of one pass of cp (a ColPass or a GLColPass) over
    (.., cp.nn, ncols), each a dict of what its kernel takes: "tall"
    (TALL_WHOLE, TALL_A, TALL_B, TALL_PRE), "key" (``variant``), "rows"
    and "ncols" (the launch's view), "inner" (the factor of nn on the
    view's columns, 1 for a whole column), "batch_mult" (the launch's
    batch rows a row of the pass's: a 'lo' group's P, else 1), "phase"
    (its TallPhase, or None), "group", "stages" (the phase's stages it
    runs), "ts"/"offsets" (its network: a 'hi' group's half sizes t / Q
    at the phase table's offsets), "log_hq"/"log_lp" (a 'hi' group's
    log2 Q, a 'lo' group's log2 P, else 0), "tile_cols", "shift", "short"
    (a launch of the short kernel, ``is_short``: tile columns 1), and the
    operands it applies: "pre_form"/"pre"/"pre2" on load,
    "post_form"/"post"/"post2", "mat", "transpose_out" and
    "canonicalize" on store (``_operand_forms``), "mid" (the tall
    network's mid vector, which a TALL_A launch's store multiplies by),
    and "store_ops" (whether it stores with the pass's store operations).

    One launch for a column without a tall route (cp.tall None: up to
    route_rows(itemsize) rows; a one-row column's is its operands alone, a
    short Goldilocks column's the short kernel's);
    a tall cp's phases' launches: a phase of up to max_rows rows is one
    (A: the 'pre' operands on load, the mid multiply and the row move on
    store; B: the 'post' operands, the transpose, 'post_t' and
    canonicalize on store), a taller one two (``phase_groups``; A's first
    takes the 'pre' operands and stores in place, its last the mid step;
    B's first stores in place, its last the store operations). max_rows:
    the limit on a phase's launch (by default route_rows(itemsize); the
    CPU tests lower it)."""
    if max_rows is None:
        max_rows = route_rows(itemsize)
    (pre_form, pre, pre2), (post_form, post, post2) = _operand_forms(cp)
    mid = cp.wmid_pairs if isinstance(cp, ColPass) else cp.wmid
    canon = getattr(cp, "canonicalize", False)
    loads = dict(pre_form=pre_form, pre=pre, pre2=pre2)
    no_load = dict(pre_form=OP_NONE, pre=None, pre2=None)
    stores = dict(post_form=post_form, post=post, post2=post2, mat=cp.wmat,
                  transpose_out=cp.transpose_out, canonicalize=canon,
                  store_ops=True)
    in_place = dict(post_form=OP_NONE, post=None, post2=None, mat=None,
                    transpose_out=False, canonicalize=False, store_ops=False)
    ts_all = tuple(t for ph in cp.phases_ts for t in ph)
    if cp.tall is None:
        short = is_short(cp.nn, itemsize)
        tl = 1 if short else tile_cols(cp.nn, ncols, itemsize)
        return [dict(loads, **stores, mid=mid, tall=TALL_WHOLE,
                     key=variant(cp), rows=cp.nn, ncols=ncols, inner=1,
                     batch_mult=1, phase=None, group=None,
                     stages=(0, len(ts_all)), ts=ts_all, offsets=cp.offsets,
                     log_hq=0, log_lp=0, tile_cols=tl, short=short,
                     shift=tile_shift(cp, tl.bit_length() - 1))]
    if ncols & (ncols - 1):
        raise ValueError(f"ncols must be a power of two, got {ncols}")
    out = []
    for ph in cp.tall:
        groups = phase_groups(ph.rows, cp.direction, max_rows)
        for i, (group, s0, s1, log_p, log_q) in enumerate(groups):
            first, last = i == 0, i == len(groups) - 1
            rows, vc, inner, mult = ph.rows, ph.inner * ncols, ph.inner, 1
            ts = ph.ts[s0:s1]
            log_hq = log_lp = 0
            if group == "hi":
                rows, vc, inner = 1 << log_p, vc << log_q, inner << log_q
                ts, log_hq = tuple(t >> log_q for t in ts), log_q
            elif group == "lo":
                rows, mult, log_lp = 1 << log_q, 1 << log_p, log_p
            if ph.phase == "A":
                tall = (TALL_A if last
                        else TALL_PRE if pre_form != OP_NONE else TALL_B)
                ops = dict(loads if first else no_load, **in_place)
            else:
                tall = TALL_B
                ops = dict(no_load, **(stores if last else in_place))
            tl = tile_cols(rows, vc, itemsize)
            name = ph.phase + ("" if len(groups) == 1 else str(i + 1))
            out.append(dict(
                ops, mid=mid, tall=tall, key=variant(cp, name), rows=rows,
                ncols=vc, inner=inner, batch_mult=mult, phase=ph,
                group=group, stages=(s0, s1), ts=ts,
                offsets=ph.offsets[s0:s1], log_hq=log_hq, log_lp=log_lp,
                tile_cols=tl, short=False,
                shift=max(5 - (tl.bit_length() - 1),
                          rows.bit_length() - 1)))
    return out


def launch_keys(cp) -> list:
    """The suffixes of cp's tall launches ('A', 'B', or 'A1', 'A2', 'B1',
    'B2' where a phase is split), in order: ``variant(cp, suffix)`` is each
    launch's key."""
    if cp.tall is None:
        return []
    max_rows = route_rows(4 if isinstance(cp, ColPass) else 8)
    out = []
    for ph in cp.tall:
        n = len(phase_groups(ph.rows, cp.direction, max_rows))
        out += [ph.phase] if n == 1 else [f"{ph.phase}{i + 1}"
                                          for i in range(n)]
    return out


def _launch_of(cp, ncols: int, phase: str, *, itemsize: int = 4) -> dict:
    """The launch of cp's plan whose key is variant(cp, phase)."""
    key = variant(cp, phase)
    for launch in launch_plan(cp, ncols, itemsize=itemsize):
        if launch["key"] == key:
            return launch
    raise ValueError(f"no launch {phase!r} of a {cp.nn}-row column pass "
                     f"(its launches: {launch_keys(cp)})")


def launch_plain(x: torch.Tensor, cp: ColPass, launch: dict) -> torch.Tensor:
    """One launch of launch_plan(cp, ncols) in plain PyTorch ops, on its
    input, (B, nn, ncols) (or a 2-D one): the whole pass
    (colpass_plain), or the launch's stages over its phase's view (B,
    rows, inner * ncols), with the operands it applies: the 'pre' ones
    before, after them the mid step (TALL_A) or the store operations
    (store_ops). Its output is (B, nn, ncols), or (B, ncols, nn) where it
    transposes; the launches of a plan compose to colpass_plain bit for
    bit."""
    if launch["tall"] == TALL_WHOLE:
        return colpass_plain(x, cp)
    return _phase_plain(x, cp, launch["phase"], launch["stages"],
                        pre=launch["pre_form"] != OP_NONE,
                        mid=launch["tall"] == TALL_A,
                        store=launch["store_ops"])


def _ptr(t):
    return t.data_ptr() if t is not None else None


def launch_batches(batch: int, mult: int = 1) -> list:
    """The (start, stop) batch rows of each launch: slices of at most
    MAX_LAUNCH_BATCH launch rows that cover range(batch) in order, where a
    batch row is `mult` launch rows (a 'lo' group's P arrays: a slice
    keeps each row's whole)."""
    step = max(1, MAX_LAUNCH_BATCH // mult)
    return [(b, min(b + step, batch)) for b in range(0, batch, step)]


def _launch(xb: torch.Tensor, cp: ColPass,
            launches: list | None = None) -> torch.Tensor:
    """cp's launches on xb (B, nn, ncols) (launch_plan's, or these of
    them, in turn)."""
    for name, t in (("tw", cp.tw_pairs), ("wmid", cp.wmid_pairs),
                    ("wmat", cp.wmat), ("pre", cp.pre), ("post", cp.post),
                    *((f"wfac[{i}]", t) for i, t in enumerate(cp.wfac or ())),
                    *((f"rank1[{i}]", t)
                      for i, t in enumerate(cp.rank1 or ()))):
        if t is not None and t.device != xb.device:
            raise ValueError(f"colpass table {name} is on {t.device}, "
                             f"input on {xb.device}")
    if not xb.is_contiguous():
        raise ValueError("the CUDA column pass takes contiguous tensors")
    B, nn, c = xb.shape
    if launches is None:
        launches = launch_plan(cp, c)
    lib = _library(cp.red.name)
    src = xb
    for launch in launches:
        out_shape = (B, c, nn) if launch["transpose_out"] else (B, nn, c)
        out = torch.empty(out_shape, dtype=torch.int32, device=xb.device)
        ph = launch["phase"]
        n = len(launch["ts"])
        tw_pairs = cp.tw_pairs if ph is None else ph.tw_pairs
        net = [n, len(cp.phases_ts[0]) if ph is None else n,
               (ctypes.c_int * n)(*launch["ts"]),
               (ctypes.c_int * n)(*launch["offsets"]), tw_pairs.data_ptr(),
               _log_a(cp) if ph is None else -1]
        tables = [_ptr(launch["mid"]), _ptr(launch["mat"]),
                  launch["pre_form"], _ptr(launch["pre"]),
                  _ptr(launch["pre2"]), launch["post_form"],
                  _ptr(launch["post"]), _ptr(launch["post2"]), log_s(cp)]
        key, mult = launch["key"], launch["batch_mult"]
        plane = nn * c
        with torch.cuda.device(xb.device):
            stream = torch.cuda.current_stream(xb.device).cuda_stream
            for b0, b1 in launch_batches(B, mult):
                err = lib.ntt_colpass(
                    src.data_ptr() + 4 * b0 * plane,
                    out.data_ptr() + 4 * b0 * plane, (b1 - b0) * mult,
                    launch["rows"], launch["ncols"],
                    launch["tile_cols"].bit_length() - 1,
                    int(cp.direction == "dit"), *net, *tables,
                    int(launch["transpose_out"]), int(launch["canonicalize"]),
                    launch["tall"], launch["inner"].bit_length() - 1,
                    launch["log_hq"], launch["log_lp"], cp.red.p,
                    *cp.red.consts, stream)
                if err != 0:
                    raise RuntimeError(
                        f"CUDA column pass launch failed ({key}): "
                        + lib.ntt_colpass_error_string(err).decode())
                colpass.launches += 1
                colpass.launches_by[key] = colpass.launches_by.get(key, 0) + 1
        src = out
    return out


def colpass(x: torch.Tensor, cp: ColPass) -> torch.Tensor:
    """Run one column pass: the CUDA kernel for a CUDA tensor (one launch
    per MAX_LAUNCH_BATCH batch rows; a tall column's two phases, each so),
    the plain version for a CPU tensor.
    ``colpass.launches`` counts kernel launches, ``colpass.launches_by``
    them by instantiation (``variant``: a tall pass's under its two
    '+tallA' and '+tallB' keys)."""
    if x.device.type == "cpu":
        return colpass_plain(x, cp)
    if x.device.type != "cuda":
        raise ValueError(f"no column pass for device {x.device}")
    xb, squeeze = _batched(x, cp)
    out = _launch(xb, cp)
    return out[0] if squeeze else out


colpass.launches = 0
colpass.launches_by = {}


def colpass_phase(x: torch.Tensor, cp: ColPass, phase: str) -> torch.Tensor:
    """One launch of a tall cp's route, the one whose key is variant(cp,
    phase) (``launch_keys``: phase 'A' or 'B', the input and output of
    ``tall_phase_plain``, or of a split phase 'A1', 'A2', 'B1', 'B2'): the
    kernel for a CUDA tensor, counted in ``colpass.launches`` as colpass
    counts it, its plain version (``launch_plain``) for a CPU tensor. The
    card's checks hold each launch against its plain version with it; the
    plans run them all through ``colpass``."""
    if phase not in launch_keys(cp):
        raise ValueError(f"no phase {phase!r} of a {cp.nn}-row column pass "
                         f"(its launches: {launch_keys(cp)})")
    ncols = x.shape[-1]
    return colpass_launch(x, cp, _launch_of(cp, ncols, phase))


def colpass_launch(x: torch.Tensor, cp: ColPass,
                   launch: dict) -> torch.Tensor:
    """One launch of launch_plan(cp, ncols, ...) on its input (also of a
    plan with a lower max_rows, whose launches the kernels take as well):
    the kernel for a CUDA tensor, counted in ``colpass.launches`` as
    colpass counts it, ``launch_plain`` for a CPU tensor."""
    xb, squeeze = _batched(x, cp)
    if xb.device.type == "cpu":
        out = launch_plain(xb, cp, launch)
    else:
        out = _launch(xb, cp, [launch])
    return out[0] if squeeze else out
