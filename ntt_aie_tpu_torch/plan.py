"""Plan builder: compiles an NTTConfig into callables on torch tensors.

Port of ``ntt_aie_tpu.plan`` for the single-chip four-step configurations
(``plan.py:269-349`` of the reference). With N = N1 x N2 and the input
viewed row-major as an (N1, N2) matrix, the fold plan (the default) runs
two column passes a transform,

    fwd = cp2 . cp1        cp1: DIF over N1, * W ('post_t'), transpose
                           cp2: DIF over N2, canonicalize
    inv = icp1 . icp2      icp2: DIT over N2, * W^-1/N ('post_t'), transpose
                           icp1: DIT over N1, canonicalize

each a column pass (``ops.colpass``: the CUDA kernel on a CUDA device, its
plain PyTorch version on the CPU). ``wmat_fold=False`` moves the
four-step multiply to the entry of the second pass of each transform, as
the column pass's 'pre' operand (cp2: * W, icp1: * W^-1/N), with the same
outputs bit for bit. ``wmat_factored=True`` takes it from the factored
tables T1[c1] * T2[c0] (``twiddles.fourstep_wfac_T``) on the passes whose
rows are the exponent's linear axis: cp2 'pre' (* W) and icp2 'post',
before its transpose (* W^-1/N); cp1 and icp1 carry no table. The
negacyclic product (X^N + 1) scales by psi^i and psi^-i inside the column
passes: ``ncp1`` is cp1 with psi as 'pre', ``nicp1`` icp1 with psi^-1 as
'post' (after the fold's plain icp1, or after its 'pre' W^-1/N without
the fold; under wmat_factored psi and psi^-1 are rank-1 operands,
``twiddles.negacyclic_psi_factors``), so it is six column passes, as the
cyclic product. ``fused=True`` runs each transform as one fused
four-step launch instead (``ops.fused_fourstep``: ``ff`` forward, ``fi``
inverse), with the same outputs bit for bit; its negacyclic product rides
the fused kernels as ``pre`` (``nf``) and ``post`` (``ni``). The flat
forward
output is in the four-step spectral order flat[c*N1 + r] =
X[s2(c)*N1 + s1(r)] (``twiddles.spectral_positions``); pointwise products
are order-agnostic, so polymul never permutes.

A flat configuration (split (n, 1), the default up to n = 2^16, where
the reference runs its XLA stage loops ``ops/stages.py`` with the batch
on lanes) runs the same kernels at an internal split
(``flat_inner_split``) and gathers their spectrum into the flat
bit-reversed order with one index (``twiddles.flat_gather``); its
negacyclic product is the fused plan's (``nf``/``ni``) whichever plan
runs the transforms. Its plain version, the oracle of that route, is
``ops.stages``.

Every reduction of ``ops.reductions`` runs both plans (harvey4, harvey,
montgomery, barrett; ``NTTConfig.reduction``, 'auto' by the prime). The
pointwise product is ``ops.pointwise.mul32``, the exact canonical product
(``Reduction.mul_data``'s) for every kind, one launch of
``csrc/pointwise.cu`` on the card, so the polymul inverse is the plain
inverse. (The reference's montgomery product is one REDC, which leaves an
R^-1 that its polymul inverse takes back with iwmat_poly; the canonical
outputs are the same.)

n = 2 on the flat split has no two-factor split: its plan
(``flat_n2_plan``) runs the one butterfly as torch ops (``ops.stages``
``FlatStages``), as the reference's flat path runs it under XLA, with the
same callables.

The reference-parity convention (``table_convention='reference'``,
``_build_reference_plan``) runs the reference device's own network
(``ops.stages.reference_network_stages``: the natural-order power table,
increasing stride; not a DFT) as torch ops, as the reference runs it
under XLA, and with ``ordering='reference'`` places its 16 blocks as the
device's swap network does. It has a forward transform only.

Public tensors are ``torch.int32`` holding values in [0, p). Goldilocks
configurations route to ``goldilocks_plan.build_goldilocks_plan``, which
returns the same ``Plan`` over (hi, lo) limb planes.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.config import NTTConfig
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops import stages as S
from ntt_aie_tpu_torch.ops.colpass import make_colpass
from ntt_aie_tpu_torch.ops.fused_fourstep import make_fused_fourstep
from ntt_aie_tpu_torch.ops.pointwise import mul32
from ntt_aie_tpu_torch.ops.reductions import make_reduction, resolve_kind
from ntt_aie_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Plan:
    """Callables of one NTTConfig on one device.

    fwd/inv/polymul take and return flat (n,) tensors; fwd_mat maps
    (n1, n2) natural layout to (n2, n1) spectral and inv_mat back
    (spectral-order plans only; None with ordering='natural');
    polymul_mat maps (n1, n2) operands to an (n1, n2) product.
    negacyclic_polymul (flat) and negacyclic_polymul_mat (matrix form)
    exist with NTTConfig(negacyclic=True), else None. A flat plan (split
    (n, 1)) has no matrix-form callables. make_batched(B) returns the same
    callables over a leading batch axis (a reference-parity plan has
    none, and raises). passes holds the four column
    passes (cp1, cp2, icp2, icp1), or on a fused plan the fused transforms
    (ff, fi), of the four-step split the plan runs (for a flat plan, the
    internal one, ``flat_inner_split``; at n = 2 the stage loops,
    "stages"), and for negacyclic the column
    passes ncp1, nicp1 of a four-step fold plan, or the fused nf, ni (on a
    flat fold plan at the fused plan's internal split). pointwise(x, y)
    is the spectral product polymul runs between its transforms: x * y
    mod p of canonical spectra of one shape, or y of x's trailing shape
    (ops.pointwise.mul32 for
    the 32-bit kinds, ops.gl_colpass.gl_mul on (hi, lo) pairs for
    Goldilocks), so inv(pointwise(fwd(a), fwd(b))) is polymul(a, b) bit
    for bit, and inv_mat(pointwise(fwd_mat(a), fwd_mat(b))) polymul_mat(a,
    b) where the plan has the matrix-form callables, and a caller may keep
    one operand's spectrum (a reference-parity plan has none).
    wmat_factored and wmat_fold record the arm that was built, as the reference's Plan
    does: wmat_factored where it was asked for on a four-step split (a
    fused plan records it too, as the reference's, and runs its fused
    kernels), wmat_fold where the four-step multiply rides the transposing
    passes' exit ('post_t': the fold passes, also a flat fold plan's at its
    internal split).
    """

    config: NTTConfig
    device: torch.device
    fwd: Callable
    inv: Callable
    polymul: Callable
    spectral_to_natural: np.ndarray
    reduction: str
    passes: dict
    fwd_mat: Optional[Callable] = None
    inv_mat: Optional[Callable] = None
    polymul_mat: Optional[Callable] = None
    negacyclic_polymul: Optional[Callable] = None
    negacyclic_polymul_mat: Optional[Callable] = None
    pointwise: Optional[Callable] = None
    wmat_factored: bool = False
    wmat_fold: bool = False
    _batched_builder: Optional[Callable] = None
    _batched_cache: dict = dataclasses.field(default_factory=dict)

    def make_batched(self, batch: int) -> dict:
        if batch not in self._batched_cache:
            if self._batched_builder is None:
                raise NotImplementedError("no batched path for this plan")
            self._batched_cache[batch] = self._batched_builder(batch)
        return self._batched_cache[batch]


# log2 n1 of a flat plan's internal split where another split than the
# square measured faster (``python -m ntt_aie_tpu_torch.scripts.flat_splits``
# on an NVIDIA H100 80GB HBM3 at 700 W, two readings each, PERF.md):
# the fold plan at n = 2^16 (1024 x 64: 1.02 us/NTT against 256 x 256's
# 1.95), 2^14 (512 x 32: 0.30 against 0.42) and 2^10 (8 x 128: 0.013
# against 0.025), the fused plan at 2^16 (128 x 512: 1.40 against 1.60).
# Goldilocks's fastest splits were the square ones.
_FOLD_ROWS_LOG2 = {16: 10, 14: 9, 10: 3}
_FUSED_ROWS_LOG2 = {16: 7}


def flat_inner_split(log_n: int, *, fused: bool = False,
                     goldilocks: bool = False) -> tuple:
    """The four-step split (n1, n2) a flat configuration (NTTConfig.split
    with n2 = 1) runs on the card: the square one, n1 = 2^ceil(log_n / 2)
    (16 x 16 at n = 256), unless another measured faster for this plan
    (_FOLD_ROWS_LOG2, _FUSED_ROWS_LOG2). n = 2 has no two-factor split
    (its plan is flat_n2_plan) and raises ValueError."""
    if log_n < 2:
        raise ValueError(f"n = {1 << log_n} has no two-factor split: its "
                         "flat plan runs the stage loops (flat_n2_plan)")
    table = ({} if goldilocks else
             _FUSED_ROWS_LOG2 if fused else _FOLD_ROWS_LOG2)
    r = table.get(log_n, (log_n + 1) // 2)
    return 1 << r, 1 << (log_n - r)


def inverse_permutation(idx: np.ndarray) -> np.ndarray:
    out = np.empty(len(idx), dtype=np.int64)
    out[idx] = np.arange(len(idx))
    return out


def public_order(config: NTTConfig, n1: int, n2: int, device) -> tuple:
    """The public spectral order of a plan that runs the four-step split
    (n1, n2): (spectral_to_natural, out_idx, in_idx). out_idx gathers the
    four-step flat spectrum into that order along the last axis (None:
    the four-step order itself); in_idx takes it back. A flat
    configuration (config.split = (n, 1)) is in bit-reversed order
    (twiddles.flat_gather), as the reference's flat plan; natural order
    gathers by spectral_positions(n1, n2) either way."""
    pos = tw.spectral_positions(n1, n2)
    flat = config.split[1] == 1
    spectral = tw.spectral_positions(config.n, 1) if flat else pos
    if config.ordering == "natural":
        out_idx = pos
    elif flat:
        out_idx = tw.flat_gather(n1, n2)
    else:
        return spectral, None, None
    return (spectral,
            torch.from_numpy(out_idx.astype(np.int64)).to(device),
            torch.from_numpy(inverse_permutation(out_idx)).to(device))


@functools.lru_cache(maxsize=1)
def _root_powers(field, n: int) -> np.ndarray:
    """twiddles.root_powers(field, n), read-only, kept for the next plan
    of the same n (the factored arms of two splits of one n, such as
    Goldilocks 2^28's, share it: at n = 2^28 it takes tens of seconds)."""
    pows = tw.root_powers(field, n)
    pows.setflags(write=False)
    return pows


def wfac_tables(field, n1: int, n2: int) -> tuple:
    """The factored four-step tables of an (n1, n2) split, as the
    reference's factored plans build them (its plan.py:229-239): the
    forward (T1, T2) and the inverse's with 1/n in T2, from one power
    table."""
    n_inv = tw.fourstep_tables_light(field, n1, n2)["n_inv"]
    pows = _root_powers(field, n1 * n2)
    return (tw.fourstep_wfac_T(field, n1, n2, _pows=pows),
            tw.fourstep_wfac_T(field, n1, n2, inverse=True, scale=n_inv,
                               _pows=pows))


def side_by_side(makers: dict, device: torch.device) -> dict:
    """{name: maker()} of a plan's passes on `device`, each maker run in a
    thread of its own: a pass's set-up is NumPy and torch work on its
    tables, which leaves the interpreter lock free on large arrays, so the
    passes of a 2^27-point plan build side by side (its set-up is the most
    of a plan's first call). A new thread starts on card 0 and its default
    stream, so on the card each maker runs on the caller's card (device's
    index, else the caller's current card: a rank that called
    torch.cuda.set_device(r) gets its tables on card r) and the caller's
    current stream, as a serial build would. A maker's exception is
    raised here."""
    index = stream = None
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        stream = torch.cuda.current_stream(index)

    def run(fn):
        if index is None:
            return fn()
        with torch.cuda.device(index), torch.cuda.stream(stream):
            return fn()

    with concurrent.futures.ThreadPoolExecutor(len(makers)) as pool:
        futures = {k: pool.submit(run, fn) for k, fn in makers.items()}
        return {k: f.result() for k, f in futures.items()}


def fold_passes(field, n1: int, n2: int, *, reduction: str = "harvey4",
                wmat_fold: bool = True, wmat_factored: bool = False,
                negacyclic: bool = False, device=None) -> dict:
    """The column passes of the four-step plan for an (n1, n2) split under
    the reduction of this kind (reference plan.py:229-310): cp1 and icp1
    over (.., n1, n2), cp2 and icp2 over (.., n2, n1). With wmat_fold (the
    default) the four-step multiply rides the transposing passes' exit as
    'post_t', with its operand in output orientation: wmat.T for cp1,
    iwmat_scaled (1/n folded in) for icp2. With wmat_fold=False it rides
    the second pass's entry as 'pre': wmat.T for cp2, iwmat_scaled for
    icp1. With wmat_factored (which overrides wmat_fold, as in the
    reference) it comes from the factored tables of
    twiddles.fourstep_wfac_T, on the passes whose rows are the exponent's
    linear axis: cp2 'pre' (W), icp2 'post' before the transpose (W^-1
    with 1/n in T2); no n1 x n2 matrix is built. The outputs are the same
    bit for bit.

    negacyclic adds ncp1 and nicp1 over (.., n1, n2), which take the place
    of cp1 and icp1 in the negacyclic product (reference plan.py:474-524,
    :697-734): ncp1 is cp1 with psi^i as 'pre'; nicp1 is icp1 with psi^-i
    as 'post' (under wmat_factored, rank-1 operands of
    twiddles.negacyclic_psi_factors, n1 + n2 values each). The polymul
    inverse is the plain one (its pointwise product is exact), so no
    iwmat_poly: the same outputs as the reference's, which builds one more
    table for montgomery. device: None is the card
    (utils.device.resolve_device)."""
    device = resolve_device(device)
    kw = dict(reduction=reduction, device=device)
    cp1_kw = dict(direction="dif", transpose_out=True, **kw)
    icp1_kw = dict(direction="dit", inverse_tw=True, canonicalize=True, **kw)
    if wmat_factored:
        wf, wf_inv = wfac_tables(field, n1, n2)
        cp2_op = dict(wfac=wf, wfac_pos="pre")
        icp2_op = dict(wfac=wf_inv, wfac_pos="post")
    elif wmat_fold:
        tabs = tw.fourstep_tables(field, n1, n2)
        cp1_kw.update(wmat=np.ascontiguousarray(tabs["wmat"].T),
                      twiddle_pos="post_t")
        cp2_op = {}
        icp2_op = dict(wmat=tabs["iwmat_scaled"], twiddle_pos="post_t")
    else:
        tabs = tw.fourstep_tables(field, n1, n2)
        icp1_kw.update(wmat=tabs["iwmat_scaled"], twiddle_pos="pre")
        cp2_op = dict(wmat=np.ascontiguousarray(tabs["wmat"].T),
                      twiddle_pos="pre")
        icp2_op = {}
    make = functools.partial(make_colpass, field)
    makers = {
        "cp1": functools.partial(make, n1, **cp1_kw),
        "cp2": functools.partial(make, n2, direction="dif",
                                 canonicalize=True, **cp2_op, **kw),
        "icp2": functools.partial(make, n2, direction="dit", inverse_tw=True,
                                  transpose_out=True, **icp2_op, **kw),
        "icp1": functools.partial(make, n1, **icp1_kw),
    }
    if negacyclic and wmat_factored:
        makers["ncp1"] = functools.partial(
            make, n1, rank1=tw.negacyclic_psi_factors(field, n1, n2),
            rank1_pos="pre", **cp1_kw)
        makers["nicp1"] = functools.partial(
            make, n1, rank1=tw.negacyclic_psi_factors(field, n1, n2,
                                                      inverse=True),
            rank1_pos="post", **icp1_kw)
    elif negacyclic:
        n = n1 * n2
        psi = tw.negacyclic_psi_powers(field, n).reshape(n1, n2)
        ipsi = tw.negacyclic_psi_powers(field, n, inverse=True)
        makers["ncp1"] = functools.partial(make, n1, wmat2=psi,
                                           twiddle_pos2="pre", **cp1_kw)
        makers["nicp1"] = functools.partial(
            make, n1, wmat2=ipsi.reshape(n1, n2), twiddle_pos2="post",
            **icp1_kw)
    return side_by_side(makers, device)


def fused_passes(field, n1: int, n2: int, *, negacyclic: bool = False,
                 reduction: str = "harvey4", device=None) -> dict:
    """The fused transforms of the fused plan for an (n1, n2) split under
    the reduction of this kind (reference plan.py:328-336, :685-689): ff
    over (.., n1, n2) with wmid = wmat.T, fi over (.., n2, n1) with wmid =
    iwmat_scaled (1/n folded in; the polymul inverse too), and with
    negacyclic those of negacyclic_passes. device: None is the card."""
    device = resolve_device(device)
    tabs = tw.fourstep_tables(field, n1, n2)
    kw = dict(reduction=reduction, device=device)
    make = functools.partial(make_fused_fourstep, field, n1, n2, **kw)
    makers = {
        "ff": functools.partial(make,
                                wmid=np.ascontiguousarray(tabs["wmat"].T)),
        "fi": functools.partial(make, inverse=True,
                                wmid=tabs["iwmat_scaled"]),
    }
    if negacyclic:
        makers.update(_negacyclic_makers(field, n1, n2, tabs, kw))
    return side_by_side(makers, device)


def negacyclic_passes(field, n1: int, n2: int, *, reduction: str = "harvey4",
                      device=None) -> dict:
    """The fused transforms of the negacyclic product for an (n1, n2)
    split: nf = ff with psi^i as 'pre', ni = fi with psi^-i as 'post'
    (reference plan.py:685-689). device: None is the card."""
    device = resolve_device(device)
    kw = dict(reduction=reduction, device=device)
    return side_by_side(_negacyclic_makers(
        field, n1, n2, tw.fourstep_tables(field, n1, n2), kw), device)


def _negacyclic_makers(field, n1: int, n2: int, tabs: dict, kw: dict) -> dict:
    """negacyclic_passes' nf and ni as makers (side_by_side's)."""
    n = n1 * n2
    make = functools.partial(make_fused_fourstep, field, n1, n2, **kw)
    return {
        "nf": functools.partial(
            make, wmid=np.ascontiguousarray(tabs["wmat"].T),
            pre=tw.negacyclic_psi_powers(field, n).reshape(n1, n2)),
        "ni": functools.partial(
            make, inverse=True, wmid=tabs["iwmat_scaled"],
            post=tw.negacyclic_psi_powers(field, n,
                                          inverse=True).reshape(n1, n2)),
    }


def build_plan(config: NTTConfig, *, device=None, fused: bool = False,
               wmat_factored: bool | None = None,
               wmat_fold: bool | None = None) -> Plan:
    """Build the plan of `config` on `device`: the four-step fold plan, or
    with fused=True the fused plan (for Goldilocks, build_goldilocks_plan;
    `fused` does not apply there, as in the reference).

    wmat_fold=False places the four-step multiply at the second pass's
    entry ('pre') instead of the first pass's exit (fold_passes), with the
    same outputs; it does not apply to the fused plan, as in the
    reference. wmat_factored=True takes the four-step multiply from the
    factored tables (cp2 'pre', icp2 'post'; fold_passes) and the
    negacyclic psi from rank-1 operands, with the same outputs; it
    overrides wmat_fold, and a fused plan records it and keeps its fused
    kernels, as in the reference. With NTTConfig(negacyclic=True) a
    four-step fold plan has negacyclic_polymul and negacyclic_polymul_mat
    on the column passes ncp1/nicp1 (psi as 'pre', psi^-1 as 'post'), a
    fused plan on nf/ni.

    A flat configuration (config.split = (n, 1), the default for a single
    shard up to n = 2^16) runs the same kernels at the internal split
    flat_inner_split(log_n, fused=fused) and gathers their spectrum into
    bit-reversed order (one index_select; pointwise products need none). Its
    callables are the reference's flat ones: fwd, inv, polymul and, with
    NTTConfig(negacyclic=True), negacyclic_polymul (psi rides the fused
    kernels as pre/post, on a fold plan at the fused plan's internal
    split), flat and through make_batched, and no matrix-form twins.
    wmat_fold and wmat_factored do not apply to it, as in the reference.
    At n = 2 it is flat_n2_plan (the stage loops as torch ops; `fused`
    does not apply).

    table_convention='reference' builds the reference-parity plan
    (_build_reference_plan), before the Goldilocks branch, as the
    reference does: Goldilocks then raises ValueError (no reduction).

    Tables are prepared once here, on the plan's device: the card when
    device is None (RuntimeError without one; device="cpu" runs the plain
    PyTorch version). A configuration with num_shards > 1 builds the
    single-device plan at its split (config.split, which num_shards
    shapes), as the reference's build_plan does: the plan the distributed
    plan (parallel.fourstep) equals bit for bit.
    """
    field = config.field
    kind = resolve_kind(config.reduction, field)
    if config.table_convention == "reference":
        return _build_reference_plan(config, kind, device)
    if kind == "goldilocks":
        from ntt_aie_tpu_torch.goldilocks_plan import build_goldilocks_plan

        return build_goldilocks_plan(config, device=device,
                                     wmat_factored=wmat_factored,
                                     wmat_fold=wmat_fold)
    red = make_reduction(kind, field)
    flat = config.split[1] == 1
    # the arm built, as the reference records it (its plan.py:193-198)
    wfac_on = bool(wmat_factored) and not flat
    fold_on = not fused and (flat or (wmat_fold is not False
                                      and not wfac_on))

    device = resolve_device(device)
    n = config.n

    def as_i32(a) -> torch.Tensor:
        return torch.as_tensor(a, device=device).to(torch.int32)

    if flat and n == 2:
        return flat_n2_plan(config, kind, device,
                            wrap1=lambda fn: lambda a: fn(as_i32(a)),
                            wrap2=lambda fn: lambda a, b: fn(as_i32(a),
                                                             as_i32(b)))
    n1, n2 = (flat_inner_split(config.log_n, fused=fused) if flat
              else config.split)
    if fused:
        passes = fused_passes(field, n1, n2, negacyclic=config.negacyclic,
                              reduction=kind, device=device)
        fwd_t, inv_t = passes["ff"], passes["fi"]
    else:
        passes = fold_passes(field, n1, n2, reduction=kind,
                             wmat_fold=fold_on, wmat_factored=wfac_on,
                             negacyclic=config.negacyclic and not flat,
                             device=device)
        if config.negacyclic and flat:  # the fused plan's product
            passes.update(negacyclic_passes(
                field, *flat_inner_split(config.log_n, fused=True),
                reduction=kind, device=device))
        cp1, cp2, icp2, icp1 = (passes[k]
                                for k in ("cp1", "cp2", "icp2", "icp1"))

        def fwd_t(x):
            return cp2(cp1(x))

        def inv_t(x):
            return icp1(icp2(x))

    def pointwise(fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
        return mul32(fa, fb, red.p)

    def fwd2d(a, shape):
        return fwd_t(as_i32(a).reshape(shape))

    def inv2d(a, shape):
        return inv_t(as_i32(a).reshape(shape))

    def poly2d(a, b, shape):
        return inv2d(pointwise(fwd2d(a, shape), fwd2d(b, shape)),
                     shape[:-2] + (n2, n1))

    nega2d = None
    if config.negacyclic and "nf" in passes:
        nf, ni = passes["nf"], passes["ni"]

        def nega2d(a, b, lead):
            fa = nf(as_i32(a).reshape(lead + nf.shape_in))
            fb = nf(as_i32(b).reshape(lead + nf.shape_in))
            return ni(pointwise(fa, fb))
    elif config.negacyclic:
        ncp1, nicp1 = passes["ncp1"], passes["nicp1"]

        def nega2d(a, b, lead):
            fa = cp2(ncp1(as_i32(a).reshape(lead + (n1, n2))))
            fb = cp2(ncp1(as_i32(b).reshape(lead + (n1, n2))))
            return nicp1(icp2(pointwise(fa, fb)))

    spectral, out_idx, in_idx = public_order(config, n1, n2, device)

    def fwd_n(a, lead):
        out = fwd2d(a, lead + (n1, n2)).reshape(lead + (n,))
        return out if out_idx is None else out.index_select(-1, out_idx)

    def inv_n(a, lead):
        a = as_i32(a).reshape(lead + (n,))
        if out_idx is not None:
            a = a.index_select(-1, in_idx)
        return inv2d(a, lead + (n2, n1)).reshape(lead + (n,))

    def callables(lead) -> dict:
        """The flat callables over a leading shape `lead`, and the
        matrix-form twins of a four-step plan."""
        sh = lead + (n1, n2)
        out = {
            "fwd": lambda a: fwd_n(a, lead),
            "inv": lambda a: inv_n(a, lead),
            "polymul": lambda a, b: poly2d(a, b, sh).reshape(lead + (n,)),
        }
        if nega2d is not None:
            out["negacyclic_polymul"] = (
                lambda a, b: nega2d(a, b, lead).reshape(lead + (n,)))
        if flat:
            return out
        out["polymul_mat"] = lambda a, b: poly2d(a, b, sh)
        if config.ordering != "natural":
            out["fwd_mat"] = lambda a: fwd2d(a, sh)
            out["inv_mat"] = lambda a: inv2d(a, lead + (n2, n1))
        if nega2d is not None:
            out["negacyclic_polymul_mat"] = lambda a, b: nega2d(a, b, lead)
        return out

    one = callables(())
    return Plan(
        config=config,
        device=device,
        fwd=one["fwd"],
        inv=one["inv"],
        polymul=one["polymul"],
        spectral_to_natural=spectral,
        reduction=kind,
        passes=passes,
        fwd_mat=one.get("fwd_mat"),
        inv_mat=one.get("inv_mat"),
        polymul_mat=one.get("polymul_mat"),
        negacyclic_polymul=one.get("negacyclic_polymul"),
        negacyclic_polymul_mat=one.get("negacyclic_polymul_mat"),
        pointwise=pointwise,
        wmat_factored=wfac_on,
        wmat_fold=fold_on,
        _batched_builder=lambda B: callables((B,)),
    )


def flat_n2_plan(config: NTTConfig, kind: str, device, *, wrap1,
                 wrap2) -> Plan:
    """The plan of n = 2 on the flat split, which has no two-factor split
    for the four-step kernels: its one butterfly as torch ops on the
    plan's device (ops.stages.FlatStages, the reference's flat stage loops
    with the batch on the columns, as the reference's flat path runs them
    under XLA, its plan.py:582-655), with the reference's flat callables:
    fwd (natural in, bit-reversed out, which at n = 2 is natural), inv,
    polymul and with NTTConfig(negacyclic=True) negacyclic_polymul (each
    operand times psi^i, the cyclic product, times psi^-i), flat and
    through make_batched, canonical. The pointwise products are
    ops.pointwise.mul32 (32-bit) or ops.gl_colpass.gl_mul (the kind
    'goldilocks'). wrap1/wrap2 put the caller's values on the device in
    the plan's value form (an int32 tensor, or a Goldilocks (hi, lo)
    pair) and back."""
    field, n = config.field, config.n
    gl = kind == "goldilocks"
    fs = S.make_flat_stages(field, n, reduction=kind, device=device)
    psi = [tw.negacyclic_psi_powers(field, n, inverse=i) for i in (0, 1)]
    if gl:
        from ntt_aie_tpu_torch.ops.gl_colpass import gl_mul as mul

        psi = [M.gl_from_u64(v, device) for v in psi]
    else:
        p = field.p
        psi = [torch.from_numpy(v.astype(np.uint32).view(np.int32)).to(device)
               for v in psi]

        def mul(a, b):
            return mul32(a, b, p)

    def polymul(a, b):
        return fs.inv(mul(fs.fwd(a), fs.fwd(b)))

    def negacyclic(a, b):
        return mul(polymul(mul(a, psi[0]), mul(b, psi[0])), psi[1])

    def callables(lead) -> dict:
        def shaped(v):
            if gl:
                return tuple(t.reshape(lead + (n,)) for t in v)
            return v.reshape(lead + (n,))

        out = {"fwd": wrap1(lambda a: fs.fwd(shaped(a))),
               "inv": wrap1(lambda a: fs.inv(shaped(a))),
               "polymul": wrap2(lambda a, b: polymul(shaped(a), shaped(b)))}
        if config.negacyclic:
            out["negacyclic_polymul"] = wrap2(
                lambda a, b: negacyclic(shaped(a), shaped(b)))
        return out

    one = callables(())
    return Plan(
        config=config,
        device=device,
        fwd=one["fwd"],
        inv=one["inv"],
        polymul=one["polymul"],
        spectral_to_natural=tw.spectral_positions(n, 1),
        reduction=kind,
        passes={"stages": fs},
        negacyclic_polymul=one.get("negacyclic_polymul"),
        pointwise=mul,
        _batched_builder=lambda B: callables((B,)),
    )


def _build_reference_plan(config: NTTConfig, kind: str, device) -> Plan:
    """Bit-exact parity with the reference device (reference
    plan.py:801-838): its butterfly network with the natural-order power
    table (twiddles.power_table) as torch ops
    (ops.stages.reference_network_stages) on an (n,) vector, and with
    ordering='reference' its 16 blocks gathered by the inverse of
    ANS_ORDER_16 (one index_select), as the device's swap network places
    them. No inverse and no product: the network is not a DFT. Goldilocks
    has no reduction and raises ValueError. device: None is the card."""
    field, n = config.field, config.n
    red = make_reduction(kind, field)
    device = resolve_device(device)
    table = tuple(torch.from_numpy(np.asarray(t).astype(np.int64)).to(device)
                  for t in red.prepare_table(tw.power_table(field, n)))
    blocks = None
    if config.ordering == "reference":
        blocks = torch.from_numpy(inverse_permutation(ref.ANS_ORDER_16)).to(
            device)

    def fwd(a):
        x = M.to_carrier(torch.as_tensor(a, device=device).reshape(n))
        y = M.from_carrier(S.reference_network_stages(x, table, red))
        if blocks is None:
            return y
        return y.reshape(16, n // 16).index_select(0, blocks).reshape(n)

    def no_inverse(*_):
        raise NotImplementedError(
            "reference table convention has no inverse (not a DFT; "
            "SURVEY.md §0)")

    return Plan(config=config, device=device, fwd=fwd, inv=no_inverse,
                polymul=no_inverse, spectral_to_natural=None,
                reduction=kind, passes={})
