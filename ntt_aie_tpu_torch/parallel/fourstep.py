"""Distributed four-step NTT on torch.distributed.

Port of ``ntt_aie_tpu/parallel/fourstep.py``. With N = N1 x N2 and the
coefficients viewed row-major as an (N1, N2) matrix whose columns are
split over the D ranks of a mesh axis:

    each rank: (N1, N2/D)
    1. pass 1: column DIFs over N1          no communication
    2. the transpose: all_to_all_single     the only collective
       and a local permute
    3. pass 2: column DIFs over N2          no communication
    -> (N2, N1) with columns split, the same spectral order as the
       single-device plan at the same split, bit for bit.

The four-step twiddle multiply rides pass 2 on the far side of the
collective from the factored tables (``wmat_factored``, the default:
lcp2 'pre', licp2 'post') or pass 1 from the rank's columns of the full
matrix (``wmat_factored=False``: lcp1 'post', licp1 'pre'); the
negacyclic psi rides pass 1 (rank-1, or a full matrix). The inverse
mirrors the forward. Every pass is a column pass (``ops.colpass``,
``ops.gl_colpass``): the CUDA kernel on the card, its plain PyTorch
version on the CPU; the device decides (the reference's ``engine`` and
``interpret`` do not apply). None of them transposes: the transpose is the
collective plus a torch permute, as the reference leaves it to XLA.

One process a rank (``parallel.launch.run_spmd`` or ``torchrun``): every
callable of a plan takes and returns this rank's block. JAX's
``all_to_all(split_axis, concat_axis, tiled=True)`` splits and
concatenates along named axes; torch's ``all_to_all_single`` splits dim 0
of its input and stacks what it receives by source rank along dim 0, so
each transpose builds a send buffer (D, planes, batch, rows, cols) with
the destination first and permutes the received one (``_bodies``).

``overlap_chunks = C`` splits the transpose into C independent
``all_to_all_single`` calls over the n1 axis (``async_op=True``, so that a
backend that overlaps can run a chunk's pass 2 while the next chunk
flies; gloo overlaps nothing), each carrying every rank's target rows
d * n1/D + c * w1 + [0, w1): the result, and every bit, is that of C = 1.
``hier_axes = (major, minor)`` decomposes each collective into two, over
the minor axis then the major one on the forward and the mirror on the
inverse (``_make_transpose_pair``), with the same bits. ``dp_axis`` adds a
leading batch axis split over a data-parallel mesh axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.config import NTTConfig
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops.colpass import make_colpass
from ntt_aie_tpu_torch.ops.gl_colpass import gl_mul, make_gl_colpass
from ntt_aie_tpu_torch.ops.pointwise import mul32
from ntt_aie_tpu_torch.ops.reductions import make_reduction, resolve_kind
from ntt_aie_tpu_torch.parallel.mesh import axis_index, axis_size
from ntt_aie_tpu_torch.plan import flat_inner_split, fold_passes, wfac_tables
from ntt_aie_tpu_torch.utils.device import resolve_device


def _regroup_rows(y: torch.Tensor, axis: int, a: int, b: int) -> torch.Tensor:
    """View `axis` (length a*b*r) as (a, b, r) blocks and swap a <-> b:
    the static send-side permutation that lets the two-phase hierarchical
    exchange land blocks in the flat collective's order (reference
    fourstep.py:42-53)."""
    shp = y.shape
    y = y.reshape(shp[:axis] + (a, b, -1) + shp[axis + 1:])
    return y.transpose(axis, axis + 1).reshape(shp)


def _a2a(send: torch.Tensor, group, async_op: bool = False):
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send.contiguous(), group=group,
                                  async_op=async_op)
    return recv, work


class _Pending:
    """A transpose collective in flight: wait() returns the received
    blocks (D, ...), the block from flat rank j at [j]."""

    def __init__(self, recv, work, finish=None):
        self.recv, self.work, self.finish = recv, work, finish

    def wait(self) -> torch.Tensor:
        self.work.wait()
        return self.recv if self.finish is None else self.finish(self.recv)


def _make_transpose_pair(ax, mesh) -> tuple:
    """The transpose collectives over `ax` and this rank's place:
    (start_fwd, start_inv, D, d). `ax` is a mesh axis name (one
    all_to_all_single), or a (major, minor) pair of names (hierarchical:
    the minor axis's exchange, then the major's on the forward, the
    mirror on the inverse; rank (g, l) is flat rank d = g * L + l). Each
    start takes a send buffer (D, ...) whose block j goes to flat rank j
    and returns a _Pending."""
    if isinstance(ax, str):
        group = mesh.get_group(ax)

        def start(send):
            return _Pending(*_a2a(send, group, True))

        return start, start, axis_size(mesh, ax), axis_index(mesh, ax)

    axg, axl = ax
    G, L = axis_size(mesh, axg), axis_size(mesh, axl)
    major, minor = mesh.get_group(axg), mesh.get_group(axl)
    d = axis_index(mesh, axg) * L + axis_index(mesh, axl)

    def start_fwd(send):
        # to the L ranks of this group: the blocks of their flat ids,
        # major-minor swapped; then to the G groups, the same swap undone
        def finish(r1):  # r1[l_src, g]: from (my g, l_src), for (g, my l)
            return _a2a(_regroup_rows(r1, 0, L, G), major)[0]

        return _Pending(*_a2a(_regroup_rows(send, 0, G, L), minor, True),
                        finish)

    def start_inv(send):
        def finish(r1):  # r1[g_src, l]: from (g_src, my l), for (my g, l)
            r2 = _a2a(_regroup_rows(r1, 0, G, L), minor)[0]
            return _regroup_rows(r2, 0, L, G)

        return _Pending(*_a2a(send, major, True), finish)

    return start_fwd, start_inv, G * L, d


def _gather_groups(ax, mesh) -> list:
    """The process groups to all_gather a shard axis over, minor first."""
    if isinstance(ax, str):
        return [mesh.get_group(ax)]
    return [mesh.get_group(ax[1]), mesh.get_group(ax[0])]


def _all_gather(t: torch.Tensor, groups: list, dim: int) -> torch.Tensor:
    for group in groups:
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        t = torch.cat(parts, dim=dim)
    return t


def _bodies(start_f, start_i, D: int, C: int, n1: int, n2: int,
            p1, p2, ip2, ip1) -> tuple:
    """The forward and inverse transforms of one rank's block, on values
    that are tuples of planes (one int32 tensor for the 32-bit fields, the
    (hi, lo) pair for Goldilocks), each (bl, rows, cols):

      fwd: (bl, n1, n2/D) -> p1 -> C transposes -> p2 -> (bl, n2, n1/D)
      inv: (bl, n2, n1/D) -> ip2 -> C transposes -> ip1 -> (bl, n1, n2/D)

    p1(v), ip1(v) and p2(v, c), ip2(v, c) (chunk c's tables) are the
    column passes (reference fourstep.py:471-562, whose batched bodies
    vmap the same passes)."""
    m, w1 = n2 // D, n1 // (D * C)

    def cat(outs):
        if len(outs) == 1:
            return outs[0]
        return tuple(torch.cat([o[k] for o in outs], dim=2)
                     for k in range(len(outs[0])))

    def fwd(v):
        v = p1(v)
        bl = v[0].shape[0]
        # send[dest, k, b, r, col] = plane k row dest*n1/D + c*w1 + r
        pend = [start_f(torch.stack(
            [t.view(bl, D, C, w1, m)[:, :, c].transpose(0, 1) for t in v],
            dim=1)) for c in range(C)]
        outs = []
        for c, pd in enumerate(pend):
            recv = pd.wait()  # (D_src, planes, bl, w1, m)
            # chunk c transposed: row src*m + col, column r
            outs.append(p2(tuple(
                recv[:, k].permute(1, 0, 3, 2).reshape(bl, n2, w1)
                .contiguous() for k in range(len(v))), c))
        return cat(outs)

    def inv(v):
        bl = v[0].shape[0]
        pend = []
        for c in range(C):
            vc = v if C == 1 else tuple(
                t[:, :, c * w1:(c + 1) * w1].contiguous() for t in v)
            y = ip2(vc, c)  # (bl, n2, w1)
            # send[dest, k, b, r, col] = plane k of y[b, dest*m + col, r]
            pend.append(start_i(torch.stack(
                [t.view(bl, D, m, w1).permute(1, 0, 3, 2) for t in y],
                dim=1)))
        z = torch.stack([pd.wait() for pd in pend])  # (C, D, planes, bl, ..)
        return ip1(tuple(
            z[:, :, k].permute(2, 1, 0, 3, 4).reshape(bl, n1, m).contiguous()
            for k in range(len(v))))

    return fwd, inv


@dataclasses.dataclass
class DistributedPlan:
    """Callables of one distributed configuration on one rank.

    fwd: this rank's (n1, n2/D) block (or (B/dp, n1, n2/D) with dp_axis)
    -> its (n2, n1/D) spectral block; inv the reverse; polymul two input
    blocks -> the product's block (cyclic); negacyclic_polymul
    (NTTConfig(negacyclic=True)) the X^n + 1 product. 32-bit plans take
    and return int32 tensors, Goldilocks plans (hi, lo) tuples of them.
    shard_input(a) puts this rank's block of a host (n,) vector (or a
    (B, n) batch with dp_axis; for Goldilocks uint64, or a (hi, lo)
    pair) on the plan's device; shard_spectral(s) the block of a flat
    spectrum in fwd's output layout. gather(y, dim=-1) all_gathers a
    block over the shard axis (both hier axes) along dim: the whole
    (n2, n1) spectrum, or the (n1, n2) coefficients, on every rank.
    spectral_to_natural is over the row-major flattened spectrum.
    shard is this rank's flat index on the shard axis, num_shards D;
    passes holds the column passes (dist_passes / gl_dist_passes).
    """

    config: NTTConfig
    mesh: object
    device: torch.device
    fwd: Callable
    inv: Callable
    polymul: Callable
    spectral_to_natural: np.ndarray
    reduction: str
    shard_input: Callable
    shard_spectral: Callable
    gather: Callable
    passes: dict
    shard: int
    num_shards: int
    dp_axis: Optional[str] = None
    negacyclic_polymul: Optional[Callable] = None
    wmat_factored: bool = False


def _lanes(tabs, sl) -> tuple:
    return tuple(np.ascontiguousarray(t[:, sl]) for t in tabs)


def _dist_passes(make, field, n1: int, n2: int, D: int, C: int, shard: int,
                 kw: dict, *, wmat_factored: bool, negacyclic: bool) -> dict:
    """dist_passes and gl_dist_passes: make is make_colpass or
    make_gl_colpass, kw the keywords of each pass ('dif1', 'dit1' over
    n1, 'dif2', 'dit2' over n2)."""
    m, w1 = n2 // D, n1 // (D * C)
    cols = slice(shard * m, (shard + 1) * m)
    lanes = [slice(shard * (n1 // D) + c * w1,
                   shard * (n1 // D) + (c + 1) * w1) for c in range(C)]
    out = {}
    if wmat_factored:
        wf, wf_inv = wfac_tables(field, n1, n2)
        out["lcp1"] = make(field, n1, **kw["dif1"])
        out["licp1"] = make(field, n1, **kw["dit1"])
        out["lcp2"] = [make(field, n2, wfac=_lanes(wf, sl), wfac_pos="pre",
                            **kw["dif2"]) for sl in lanes]
        out["licp2"] = [make(field, n2, wfac=_lanes(wf_inv, sl),
                             wfac_pos="post", **kw["dit2"]) for sl in lanes]
        if negacyclic:
            for key, inverse, pos, k in (("lcp1n", False, "pre", "dif1"),
                                         ("licp1n", True, "post", "dit1")):
                row, col = tw.negacyclic_psi_factors(field, n1, n2,
                                                     inverse=inverse)
                out[key] = make(field, n1, rank1=(row, col[cols]),
                                rank1_pos=pos, **kw[k])
        return out
    tabs = tw.fourstep_tables(field, n1, n2)
    wmat = np.ascontiguousarray(tabs["wmat"][:, cols])
    iwmat = np.ascontiguousarray(tabs["iwmat_scaled"][:, cols])
    out["lcp1"] = make(field, n1, wmat=wmat, twiddle_pos="post", **kw["dif1"])
    out["licp1"] = make(field, n1, wmat=iwmat, twiddle_pos="pre",
                        **kw["dit1"])
    out["lcp2"] = [make(field, n2, **kw["dif2"])] * C
    out["licp2"] = [make(field, n2, **kw["dit2"])] * C
    if negacyclic:
        psi, ipsi = (np.ascontiguousarray(tw.negacyclic_psi_powers(
            field, n1 * n2, inverse=inverse).reshape(n1, n2)[:, cols])
            for inverse in (False, True))
        out["lcp1n"] = make(field, n1, wmat=wmat, twiddle_pos="post",
                            wmat2=psi, twiddle_pos2="pre", **kw["dif1"])
        out["licp1n"] = make(field, n1, wmat=iwmat, twiddle_pos="pre",
                             wmat2=ipsi, twiddle_pos2="post", **kw["dit1"])
    return out


def dist_passes(field, n1: int, n2: int, D: int, C: int, shard: int, *,
                reduction: str = "harvey4", wmat_factored: bool = True,
                negacyclic: bool = False, device=None) -> dict:
    """The column passes of rank `shard` of D in the 32-bit distributed
    plan of an (n1, n2) split with C overlap chunks (reference
    fourstep.py:334-469), none transposing: lcp1 and licp1 over
    (.., n1, n2/D), the columns this rank holds; lcp2 and licp2 lists of
    C passes over (.., n2, n1/(D*C)), chunk c's lanes; with negacyclic
    lcp1n and licp1n in place of lcp1 and licp1.

      wmat_factored (default)     wmat_factored=False
      lcp1   DIF                  DIF, 'post' wmat
      lcp2   'pre' wfac, DIF,     DIF, canonicalize
             canonicalize
      licp2  DIT, 'post' wfac^-1  DIT
      licp1  DIT, canonicalize    'pre' iwmat, DIT, canonicalize
      lcp1n  'pre' rank-1 psi,    'pre' psi, DIF, 'post' wmat
             DIF
      licp1n DIT, 'post' rank-1   'pre' iwmat, DIT, 'post' psi^-1,
             psi^-1, canonicalize canonicalize

    The wfac tables' lanes, the matrices' columns and the rank-1 column
    vector are sliced to the rank's (and the chunk's) share. The polymul
    inverse is the plain one (the pointwise product is exact), so the
    reference's montgomery iwmat_poly has no counterpart. device: None is
    the card."""
    base = dict(reduction=reduction, device=resolve_device(device))
    dit = dict(direction="dit", inverse_tw=True, **base)
    kw = {"dif1": dict(direction="dif", **base),
          "dit1": dict(canonicalize=True, **dit),
          "dif2": dict(direction="dif", canonicalize=True, **base),
          "dit2": dit}
    return _dist_passes(make_colpass, field, n1, n2, D, C, shard, kw,
                        wmat_factored=wmat_factored, negacyclic=negacyclic)


def gl_dist_passes(field, n1: int, n2: int, D: int, C: int, shard: int, *,
                   wmat_factored: bool = True, negacyclic: bool = False,
                   device=None) -> dict:
    """dist_passes for Goldilocks (reference fourstep.py:793-868): the
    same passes and keys on limb planes, with the same operands, values
    canonical throughout (no canonicalize). device: None is the card."""
    device = resolve_device(device)
    dif = dict(direction="dif", device=device)
    dit = dict(direction="dit", inverse_tw=True, device=device)
    return _dist_passes(make_gl_colpass, field, n1, n2, D, C, shard,
                        {"dif1": dif, "dit1": dit, "dif2": dif, "dit2": dit},
                        wmat_factored=wmat_factored, negacyclic=negacyclic)


def _layout(config, mesh, ax, overlap_chunks, device) -> tuple:
    """Checks and the transpose of a distributed configuration: (start_f,
    start_i, D, d, C); the reference's messages."""
    if getattr(mesh, "device_type", device.type) != device.type:
        raise ValueError(f"the mesh is on {mesh.device_type}, the plan's "
                         f"device is {device}")
    start_f, start_i, D, d = _make_transpose_pair(ax, mesh)
    n1, n2 = config.split
    if n2 % D:
        raise ValueError(f"n2={n2} must divide by mesh axis size {D}")
    if n1 % D:
        raise ValueError(f"n1={n1} must divide by mesh axis size {D} (for "
                         "the transpose)")
    C = overlap_chunks
    if C < 1:
        raise ValueError("overlap_chunks must be >= 1")
    if n1 % (D * C):
        raise ValueError(f"n1={n1} must divide by D*overlap_chunks={D * C} "
                         "for chunked overlap")
    return start_f, start_i, D, d, C


def _placers(config, mesh, dp_axis, D: int, d: int, device, planes):
    """(shard_input, shard_spectral, blocks): place this rank's block of a
    host array (n,) or, with dp_axis, (B, n) into (n1, n2/D) or (n2, n1/D)
    as the plan's planes (planes(host array) -> tuple of int64 tensors);
    blocks(v) checks a value's planes and gives them the batch axis."""
    n1, n2 = config.split

    def place(a, rows, cols):
        vals = planes(a)
        flat = vals[0].shape
        if len(flat) == 2 and dp_axis is not None:
            B, k = flat[0], axis_size(mesh, dp_axis)
            if B % k:
                raise ValueError(f"batch {B} must divide by the dp axis "
                                 f"size {k}")
            bl = B // k
            b0 = axis_index(mesh, dp_axis) * bl
            vals = tuple(v[b0:b0 + bl] for v in vals)
        elif flat != (config.n,):
            raise ValueError(
                f"expected a flat ({config.n},) vector"
                + (" or a (B, n) batch" if dp_axis is not None else
                   " (a batch needs dp_axis)") + f", got {tuple(flat)}")
        w = cols // D
        return tuple(
            v.reshape(v.shape[:-1] + (rows, cols))[..., d * w:(d + 1) * w]
            .to(device=device, dtype=torch.int32).contiguous()
            for v in vals)

    def blocks(v, rows, cols):
        want = 3 if dp_axis is not None else 2
        out = []
        for t in v:
            t = torch.as_tensor(t, device=device).to(torch.int32)
            if t.dim() != want or tuple(t.shape[-2:]) != (rows, cols // D):
                raise ValueError(
                    f"expected this rank's ({'B/dp, ' if want == 3 else ''}"
                    f"{rows}, {cols // D}) block, got {tuple(t.shape)}")
            out.append(t if want == 3 else t.unsqueeze(0))
        return tuple(out)

    return ((lambda a: place(a, n1, n2)), (lambda s: place(s, n2, n1)),
            blocks)


def _int_planes(a) -> tuple:
    if isinstance(a, torch.Tensor):
        return (a.to(torch.int64),)
    return (torch.from_numpy(np.asarray(a).astype(np.int64)),)


def build_distributed_plan(config: NTTConfig, mesh, *, device=None,
                           dp_axis: str | None = None,
                           overlap_chunks: int = 1,
                           wmat_factored: bool | None = None,
                           hier_axes: tuple | None = None) -> DistributedPlan:
    """The 32-bit distributed plan of `config` over `mesh`'s
    config.mesh_axis (reference fourstep.py:141-642), for this rank.

    Input is this rank's (n1, n2/D) block of the row-major (n1, n2)
    coefficient matrix (plan.shard_input places a host vector); output
    its (n2, n1/D) block of the spectrum, which, flattened row-major
    after plan.gather, is the single-device plan's flat spectral output
    at the same split, bit for bit. One all_to_all_single a transform
    (C with overlap_chunks=C; two a chunk with hier_axes).

    wmat_factored: None or True (the reference's distributed default)
    takes the four-step multiply from the factored tables on pass 2 and
    psi from rank-1 vectors on pass 1; False from the rank's columns of the
    full matrices on pass 1 (dist_passes). dp_axis: a 2-D mesh's
    data-parallel axis; blocks then carry a leading batch axis (B/dp, ..).
    hier_axes = (major, minor) decomposes the transpose over two axes
    whose product is the shard count. device: None is the card (raises
    without one); "cpu" the plain PyTorch route, with a CPU mesh."""
    device = resolve_device(device)
    field = config.field
    if field.is_goldilocks:
        raise ValueError("Goldilocks runs build_gl_distributed_plan")
    kind = resolve_kind(config.reduction, field)
    red = make_reduction(kind, field)
    ax = tuple(hier_axes) if hier_axes is not None else config.mesh_axis
    start_f, start_i, D, d, C = _layout(config, mesh, ax, overlap_chunks,
                                        device)
    n1, n2 = config.split
    wfac_on = True if wmat_factored is None else bool(wmat_factored)
    passes = dist_passes(field, n1, n2, D, C, d, reduction=kind,
                         wmat_factored=wfac_on,
                         negacyclic=config.negacyclic, device=device)

    def one(cp):
        return lambda v: (cp(v[0]),)

    def chunked(cps):
        return lambda v, c: (cps[c](v[0]),)

    p2, ip2 = chunked(passes["lcp2"]), chunked(passes["licp2"])
    fwd_b, inv_b = _bodies(start_f, start_i, D, C, n1, n2,
                           one(passes["lcp1"]), p2, ip2, one(passes["licp1"]))
    shard_input, shard_spectral, blocks = _placers(config, mesh, dp_axis, D,
                                                   d, device, _int_planes)

    def out(v):
        return v[0] if dp_axis is not None else v[0][0]

    def pointwise(fa, fb):
        return tuple(mul32(a, b, red.p) for a, b in zip(fa, fb))

    def product(fwd_body, inv_body):
        def call(a, b):
            fa = fwd_body(blocks((a,), n1, n2))
            fb = fwd_body(blocks((b,), n1, n2))
            return out(inv_body(pointwise(fa, fb)))

        return call

    nega = None
    if config.negacyclic:
        nega = product(*_bodies(start_f, start_i, D, C, n1, n2,
                                one(passes["lcp1n"]), p2, ip2,
                                one(passes["licp1n"])))
    groups = _gather_groups(ax, mesh)
    return DistributedPlan(
        config=config, mesh=mesh, device=device,
        fwd=lambda a: out(fwd_b(blocks((a,), n1, n2))),
        inv=lambda s: out(inv_b(blocks((s,), n2, n1))),
        polymul=product(fwd_b, inv_b),
        spectral_to_natural=tw.spectral_positions(n1, n2),
        reduction=kind,
        shard_input=lambda a: shard_input(a)[0],
        shard_spectral=lambda s: shard_spectral(s)[0],
        gather=lambda y, dim=-1: _all_gather(y, groups, dim),
        passes=passes, shard=d, num_shards=D, dp_axis=dp_axis,
        negacyclic_polymul=nega, wmat_factored=wfac_on)


def _gl_planes(a) -> tuple:
    if isinstance(a, tuple):
        return tuple(torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v).to(torch.int64) for v in a)
    v = np.asarray(a, dtype=np.uint64)
    return (torch.from_numpy((v >> np.uint64(32)).astype(np.int64)),
            torch.from_numpy((v & np.uint64(0xFFFFFFFF)).astype(np.int64)))


def build_gl_distributed_plan(config: NTTConfig, mesh, *, device=None,
                              overlap_chunks: int = 1,
                              dp_axis: str | None = None,
                              hier_axes: tuple | None = None,
                              wmat_factored: bool | None = None
                              ) -> DistributedPlan:
    """The Goldilocks distributed plan (reference fourstep.py:677-1150):
    build_distributed_plan's structure, options and bits on (hi, lo)
    int32 limb planes (gl_dist_passes), both planes of a chunk in one
    all_to_all_single (stacked). Callables take and return (hi, lo)
    tuples of this rank's blocks; shard_input and shard_spectral take a
    uint64 host vector (or a (B, n) batch with dp_axis) or a (hi, lo)
    pair of host arrays. The pointwise product is ops.gl_colpass.gl_mul.
    device: None is the card."""
    device = resolve_device(device)
    field = config.field
    if not field.is_goldilocks:
        raise ValueError(f"the Goldilocks plan needs p = 2^64 - 2^32 + 1, "
                         f"got p={field.p}")
    ax = tuple(hier_axes) if hier_axes is not None else config.mesh_axis
    start_f, start_i, D, d, C = _layout(config, mesh, ax, overlap_chunks,
                                        device)
    n1, n2 = config.split
    wfac_on = True if wmat_factored is None else bool(wmat_factored)
    passes = gl_dist_passes(field, n1, n2, D, C, d, wmat_factored=wfac_on,
                            negacyclic=config.negacyclic, device=device)
    p2 = lambda v, c: passes["lcp2"][c](v)  # noqa: E731
    ip2 = lambda v, c: passes["licp2"][c](v)  # noqa: E731
    fwd_b, inv_b = _bodies(start_f, start_i, D, C, n1, n2, passes["lcp1"],
                           p2, ip2, passes["licp1"])
    shard_input, shard_spectral, blocks = _placers(config, mesh, dp_axis, D,
                                                   d, device, _gl_planes)

    def out(v):
        return v if dp_axis is not None else tuple(t[0] for t in v)

    def product(fwd_body, inv_body):
        def call(a, b):
            fa = fwd_body(blocks(a, n1, n2))
            fb = fwd_body(blocks(b, n1, n2))
            return out(inv_body(gl_mul(fa, fb)))

        return call

    nega = None
    if config.negacyclic:
        nega = product(*_bodies(start_f, start_i, D, C, n1, n2,
                                passes["lcp1n"], p2, ip2, passes["licp1n"]))
    groups = _gather_groups(ax, mesh)
    return DistributedPlan(
        config=config, mesh=mesh, device=device,
        fwd=lambda a: out(fwd_b(blocks(a, n1, n2))),
        inv=lambda s: out(inv_b(blocks(s, n2, n1))),
        polymul=product(fwd_b, inv_b),
        spectral_to_natural=tw.spectral_positions(n1, n2),
        reduction="goldilocks",
        shard_input=shard_input, shard_spectral=shard_spectral,
        gather=lambda y, dim=-1: tuple(_all_gather(t, groups, dim)
                                       for t in y),
        passes=passes, shard=d, num_shards=D, dp_axis=dp_axis,
        negacyclic_polymul=nega, wmat_factored=wfac_on)


# ---------------------------------------------------------------------------
# Reference-style pairwise exchange (comparison mode)
# ---------------------------------------------------------------------------

def pairwise_global_stage(x_local: torch.Tensor, stage_idx: int, D: int,
                          group, w_tables: tuple, red, *,
                          rank: int | None = None) -> torch.Tensor:
    """One cross-shard Gentleman-Sande stage (reference fourstep.py:649-670):
    rank d of `group` pairs with d ^ (D >> (stage_idx + 1)), both swap
    their blocks and each computes its half of the butterfly. x_local:
    this rank's (m,) or (m, c) block as int64 carriers in the
    reduction's domain; w_tables: this rank's twiddle slice, prepared
    (red.prepare_table, as carriers). The swap is an all_to_all_single
    whose split sizes are zero but for the partner (gloo's send/recv take
    CPU tensors only)."""
    half = D >> (stage_idx + 1)
    me = dist.get_rank(group) if rank is None else rank
    sizes = [0] * D
    sizes[me ^ half] = x_local.shape[0]
    x_local = x_local.contiguous()
    other = torch.empty_like(x_local)
    dist.all_to_all_single(other, x_local, sizes, sizes, group=group)
    if me & half:
        return red.mul_const(red.sub(other, x_local), *w_tables)
    return red.add(x_local, other)


def build_pairwise_plan(config: NTTConfig, mesh, *, device=None) -> tuple:
    """The forward NTT in the reference's scaling topology (reference
    fourstep.py:1153-1222): the first log2(D) butterfly stages exchange
    shard halves pairwise (pairwise_global_stage), then the remaining
    stages run on each rank as the flat transform of its m = n/D values
    (the column kernels at plan.flat_inner_split(log2 m), gathered into
    bit-reversed order; the stage loops at m = 2). Input: this rank's
    contiguous (m,) block of the flat vector; output: its block of the
    standard DIF bit-reversed order, canonical. Returns (fwd, shard_input)
    (shard_input: this rank's block of a host vector, on the device)."""
    device = resolve_device(device)
    field = config.field
    kind = resolve_kind(config.reduction, field)
    red = make_reduction(kind, field)
    n = config.n
    ax = config.mesh_axis
    D, d = axis_size(mesh, ax), axis_index(mesh, ax)
    group = mesh.get_group(ax)
    logd = D.bit_length() - 1
    m = n // D
    if m * D != n or m < 2:
        raise ValueError(f"n={n} must split into >=2 rows per device over "
                         f"D={D}")

    def carriers(tabs):
        return tuple(torch.from_numpy(np.asarray(t).astype(np.int64))
                     .to(device) for t in tabs)

    vecs = tw.dif_stage_twiddles(field, n)
    cross = []
    for s in range(logd):
        half = D >> (s + 1)
        k = min(d, d ^ half) & (2 * half - 1)
        cross.append(carriers(red.prepare_table(vecs[s][k * m:(k + 1) * m])))
    if m >= 4:
        n1, n2 = flat_inner_split(m.bit_length() - 1)
        fold = fold_passes(field, n1, n2, reduction=kind, device=device)
        gather = torch.from_numpy(tw.flat_gather(n1, n2)).to(device)

        def local(x):
            y = fold["cp2"](fold["cp1"](x.reshape(1, n1, n2)))
            return y.reshape(m).index_select(0, gather)
    else:
        from ntt_aie_tpu_torch.ops.stages import make_flat_stages

        local = make_flat_stages(field, m, reduction=kind, device=device).fwd

    def fwd(a):
        x = M.to_carrier(torch.as_tensor(a, device=device).to(torch.int32))
        for s in range(logd):
            x = pairwise_global_stage(x, s, D, group, cross[s], red, rank=d)
        return local(M.from_carrier(red.canonicalize(x)))

    def shard_input(a):
        v = torch.as_tensor(np.asarray(a).astype(np.int64))
        return v[d * m:(d + 1) * m].to(device=device, dtype=torch.int32)

    return fwd, shard_input
