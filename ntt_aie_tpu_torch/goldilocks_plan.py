"""Plan for the Goldilocks field p = 2^64 - 2^32 + 1.

Port of ``ntt_aie_tpu.goldilocks_plan`` for its four-step arms
(``goldilocks_plan.py:201-327``, ``:454-583`` of the reference: the fold
arm, ``wmat_fold=False`` with the four-step matrix as cp2's and icp1's
'pre', ``wmat_factored=True`` with the factored tables as cp2's 'pre' and
icp2's 'post'), its flat arm (``:353-388``: here the fold plan's column
passes at an internal split and one gather into bit-reversed order, as
``plan.py``'s flat arm; the plain version is ``ops.stages``) and its
negacyclic product at every split (``:414-424``, ``:508-568``). Field
elements travel as (hi, lo) limb planes, and the transform has the same
four-step shape as ``plan.py``:

    fwd = cp2 . cp1        cp1: DIF over N1, transpose, * W ('post_t')
                           cp2: DIF over N2
    inv = icp1 . icp2      icp2: DIT over N2, transpose, * W^-1/N ('post_t')
                           icp1: DIT over N1

each a Goldilocks column pass (``ops.gl_colpass``: the CUDA kernel on a CUDA
device, its plain PyTorch version on the CPU), and polymul's pointwise
product is ``ops.gl_colpass.gl_mul``. Values are canonical at every step.

Value interface, as the reference's: every callable takes either a
``(hi, lo)`` tuple of ``torch.int32`` tensors holding uint32 bit patterns
and returns a tuple, or a NumPy ``uint64`` array and returns ``uint64``
(split and joined on the host).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.config import NTTConfig
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops.gl_colpass import gl_mul, make_gl_colpass
from ntt_aie_tpu_torch.plan import (Plan, flat_inner_split, flat_n2_plan,
                                    public_order, side_by_side, wfac_tables)
from ntt_aie_tpu_torch.utils.device import resolve_device


def gl_fold_passes(field, n1: int, n2: int, *, wmat_fold: bool = True,
                   wmat_factored: bool = False, device=None) -> dict:
    """The four Goldilocks column passes of the four-step plan for an
    (n1, n2) split (reference goldilocks_plan.py:222-270), with the
    keywords of plan.fold_passes: cp1 and icp1 over (.., n1, n2), cp2 and
    icp2 over (.., n2, n1). With wmat_fold (the default) the four-step
    multiply rides the transposing passes' exit as 'post_t', with its
    operand in output orientation: wmat.T for cp1, iwmat_scaled (1/n
    folded in) for icp2. With wmat_fold=False it rides the second pass's
    entry as 'pre': wmat.T for cp2, iwmat_scaled for icp1. With
    wmat_factored (which overrides wmat_fold) it comes from
    twiddles.fourstep_wfac_T's factored tables: cp2 'pre', icp2 'post'
    before its transpose (1/n in T2); no n1 x n2 matrix is built. The
    outputs are the same bit for bit. device: None is the card."""
    device = resolve_device(device)
    cp1_op, cp2_op, icp2_op, icp1_op = {}, {}, {}, {}
    if wmat_factored:
        wf, wf_inv = wfac_tables(field, n1, n2)
        cp2_op = dict(wfac=wf, wfac_pos="pre")
        icp2_op = dict(wfac=wf_inv, wfac_pos="post")
    else:
        tabs = tw.fourstep_tables(field, n1, n2)
        wmat_t = np.ascontiguousarray(tabs["wmat"].T)
        if wmat_fold:
            cp1_op = dict(wmat=wmat_t)
            icp2_op = dict(wmat=tabs["iwmat_scaled"])
        else:
            cp2_op = dict(wmat=wmat_t, twiddle_pos="pre")
            icp1_op = dict(wmat=tabs["iwmat_scaled"], twiddle_pos="pre")
    make = functools.partial(make_gl_colpass, field, device=device)
    return side_by_side({
        "cp1": functools.partial(make, n1, direction="dif",
                                 transpose_out=True, **cp1_op),
        "cp2": functools.partial(make, n2, direction="dif", **cp2_op),
        "icp2": functools.partial(make, n2, direction="dit", inverse_tw=True,
                                  transpose_out=True, **icp2_op),
        "icp1": functools.partial(make, n1, direction="dit", inverse_tw=True,
                                  **icp1_op),
    }, device)


def value_io(device) -> tuple:
    """(wrap1, wrap2): wrappers of one- and two-operand callables on (hi,
    lo) planes that take the plan's value interface on `device`: a (hi,
    lo) tuple of int32 tensors (moved to the device, a tuple back) or a
    NumPy uint64 array (split on the host, joined back)."""

    def to_planes(x):
        """(hi, lo) tuple or uint64 array -> ((hi, lo) on device, as_u64)."""
        if isinstance(x, tuple):
            hi, lo = x
            if not (isinstance(hi, torch.Tensor) and hi.dtype == torch.int32
                    and isinstance(lo, torch.Tensor)
                    and lo.dtype == torch.int32):
                raise TypeError("a Goldilocks limb pair is a (hi, lo) tuple "
                                "of torch.int32 tensors")
            return (hi.to(device), lo.to(device)), False
        return M.gl_from_u64(x, device), True

    def wrap1(fn):
        def call(a):
            hl, as_u64 = to_planes(a)
            out = fn(hl)
            return M.gl_to_u64(*out) if as_u64 else out

        return call

    def wrap2(fn):
        def call(a, b):
            ahl, as_u64 = to_planes(a)
            bhl, _ = to_planes(b)
            out = fn(ahl, bhl)
            return M.gl_to_u64(*out) if as_u64 else out

        return call

    return wrap1, wrap2


def build_goldilocks_plan(config: NTTConfig, *, device=None,
                          wmat_fold: bool | None = None,
                          wmat_factored: bool | None = None) -> Plan:
    """Build the Goldilocks plan of `config` on `device`: the four-step
    plan (the fold arm; wmat_fold=False, the four-step multiply at the
    second passes' entry; wmat_factored=True, from the factored tables:
    gl_fold_passes), or for a flat configuration (config.split = (n, 1),
    the default up to n = 2^14) the fold arm's column passes at the
    internal split plan.flat_inner_split(log_n, goldilocks=True) with
    their spectrum gathered into bit-reversed order, and the reference's
    flat callables (no matrix-form twins; wmat_fold and wmat_factored do
    not apply). Plan.wmat_fold and Plan.wmat_factored record the arm
    built. n = 2 has no two-factor split: its flat plan is
    plan.flat_n2_plan (the stage loops as torch ops, gl_mul the product).

    With NTTConfig(negacyclic=True), at every split, negacyclic_polymul
    is the reference's (goldilocks_plan.py:414-424, :508-568): gl_mul by
    psi^i on each operand, the cyclic product, gl_mul by psi^-i; psi and
    psi^-i are held once and broadcast over a batch.

    Tables are prepared once here, on the plan's device (None: the card,
    RuntimeError without one). A configuration with num_shards > 1 builds
    the single-device plan at config.split, as the reference's does; the
    distributed plan is parallel.fourstep.build_gl_distributed_plan.
    """
    field = config.field
    if not field.is_goldilocks:
        raise ValueError(f"the Goldilocks plan needs p = 2^64 - 2^32 + 1, "
                         f"got p={field.p}")
    flat = config.split[1] == 1
    # the arm built, as the reference records it (its goldilocks_plan.py
    # :200-203)
    wfac_on = bool(wmat_factored) and not flat
    fold_on = flat or (wmat_fold is not False and not wfac_on)

    device = resolve_device(device)
    n = config.n
    wrap1, wrap2 = value_io(device)
    if flat and n == 2:
        return flat_n2_plan(config, "goldilocks", device, wrap1=wrap1,
                            wrap2=wrap2)
    n1, n2 = (flat_inner_split(config.log_n, goldilocks=True) if flat
              else config.split)
    passes = gl_fold_passes(field, n1, n2, wmat_fold=fold_on,
                            wmat_factored=wfac_on, device=device)
    cp1, cp2, icp2, icp1 = (passes[k] for k in ("cp1", "cp2", "icp2", "icp1"))

    def reshape(hl, shape):
        return tuple(v.reshape(shape) for v in hl)

    def fwd2d(hl, shape):
        return cp2(cp1(reshape(hl, shape)))

    def inv2d(hl, shape):
        return icp1(icp2(reshape(hl, shape)))

    def poly2d(a, b, shape):
        return inv2d(gl_mul(fwd2d(a, shape), fwd2d(b, shape)),
                     shape[:-2] + (n2, n1))

    psi = psi_inv = None
    if config.negacyclic:
        psi, psi_inv = (M.gl_from_u64(tw.negacyclic_psi_powers(
            field, n, inverse=inverse).reshape(n1, n2), device)
            for inverse in (False, True))

    def nega2d(a, b, shape):
        """psi and psi^-1, (n1, n2), broadcast over shape's leading
        axes."""
        ta = gl_mul(reshape(a, shape), psi)
        tb = gl_mul(reshape(b, shape), psi)
        return gl_mul(poly2d(ta, tb, shape), psi_inv)

    spectral, out_idx, in_idx = public_order(config, n1, n2, device)

    def take(hl, idx):
        return tuple(v.index_select(-1, idx) for v in hl)

    def fwd_n(a, lead):
        out = reshape(fwd2d(a, lead + (n1, n2)), lead + (n,))
        return out if out_idx is None else take(out, out_idx)

    def inv_n(a, lead):
        a = reshape(a, lead + (n,))
        if out_idx is not None:
            a = take(a, in_idx)
        return reshape(inv2d(a, lead + (n2, n1)), lead + (n,))

    def callables(lead) -> dict:
        """The flat callables over a leading shape `lead`, and the
        matrix-form twins of a four-step plan, on the u64/limb-pair
        value interface."""
        sh = lead + (n1, n2)
        flat_sh = lead + (n,)
        out = {
            "fwd": wrap1(lambda a: fwd_n(a, lead)),
            "inv": wrap1(lambda a: inv_n(a, lead)),
            "polymul": wrap2(lambda a, b: reshape(poly2d(a, b, sh),
                                                  flat_sh)),
        }
        if psi is not None:
            out["negacyclic_polymul"] = wrap2(lambda a, b: reshape(
                nega2d(a, b, sh), flat_sh))
        if flat:
            return out
        out["polymul_mat"] = wrap2(lambda a, b: poly2d(a, b, sh))
        if config.ordering == "bitrev":
            out["fwd_mat"] = wrap1(lambda a: fwd2d(a, sh))
            out["inv_mat"] = wrap1(lambda a: inv2d(a, lead + (n2, n1)))
        if psi is not None:
            out["negacyclic_polymul_mat"] = wrap2(
                lambda a, b: nega2d(a, b, sh))
        return out

    one = callables(())
    return Plan(
        config=config,
        device=device,
        fwd=one["fwd"],
        inv=one["inv"],
        polymul=one["polymul"],
        spectral_to_natural=spectral,
        reduction="goldilocks",
        passes=passes,
        fwd_mat=one.get("fwd_mat"),
        inv_mat=one.get("inv_mat"),
        polymul_mat=one.get("polymul_mat"),
        negacyclic_polymul=one.get("negacyclic_polymul"),
        negacyclic_polymul_mat=one.get("negacyclic_polymul_mat"),
        pointwise=gl_mul,
        wmat_factored=wfac_on,
        wmat_fold=fold_on,
        _batched_builder=lambda B: callables((B,)),
    )
