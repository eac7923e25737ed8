"""Plan for the Goldilocks field p = 2^64 - 2^32 + 1.

Port of ``ntt_aie_tpu.goldilocks_plan`` for its four-step fold arm
(``goldilocks_plan.py:244-327``, ``:454-583`` of the reference). Field
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

import numpy as np
import torch

from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.config import NTTConfig
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops.gl_colpass import gl_mul, make_gl_colpass
from ntt_aie_tpu_torch.plan import Plan, _not_ported
from ntt_aie_tpu_torch.utils.device import resolve_device


def gl_fold_passes(field, n1: int, n2: int, *, device=None) -> dict:
    """The four Goldilocks column passes of the fold plan for an (n1, n2)
    split (reference goldilocks_plan.py:244-259): cp1 and icp1 over
    (.., n1, n2), cp2 and icp2 over (.., n2, n1). The four-step multiply
    rides the transposing passes' exit as 'post_t', with its operand in
    output orientation: wmat.T for cp1, iwmat_scaled (1/n folded in) for
    icp2. device: None is the card."""
    device = resolve_device(device)
    tabs = tw.fourstep_tables(field, n1, n2)
    return {
        "cp1": make_gl_colpass(field, n1, direction="dif", transpose_out=True,
                               wmat=np.ascontiguousarray(tabs["wmat"].T),
                               device=device),
        "cp2": make_gl_colpass(field, n2, direction="dif", device=device),
        "icp2": make_gl_colpass(field, n2, direction="dit", inverse_tw=True,
                                transpose_out=True, wmat=tabs["iwmat_scaled"],
                                device=device),
        "icp1": make_gl_colpass(field, n1, direction="dit", inverse_tw=True,
                                device=device),
    }


def build_goldilocks_plan(config: NTTConfig, *, device=None,
                          wmat_fold: bool | None = None,
                          wmat_factored: bool | None = None) -> Plan:
    """Build the Goldilocks four-step fold plan of `config` on `device`.

    Tables are prepared once here, on the plan's device (None: the card,
    RuntimeError without one). The flat split,
    negacyclic products and the factored or unfolded wmat arms raise
    NotImplementedError naming the ROADMAP.md item that ports them.
    """
    field = config.field
    if not field.is_goldilocks:
        raise ValueError(f"the Goldilocks plan needs p = 2^64 - 2^32 + 1, "
                         f"got p={field.p}")
    n1, n2 = config.split
    if n2 == 1:
        _not_ported(f"the Goldilocks flat split {config.split} (pin "
                    "rows_log2 for a four-step plan)", "Queue 1 item 4h")
    if config.negacyclic:
        _not_ported("Goldilocks negacyclic polymul", "Queue 1 item 4d")
    if wmat_factored:
        _not_ported("wmat_factored=True", "Queue 1 item 4g")
    if wmat_fold is False:
        _not_ported("wmat_fold=False", "Queue 1 item 4g")
    if config.num_shards != 1:
        _not_ported("the distributed plan", "Queue 1 item 10")

    device = resolve_device(device)
    n = config.n
    pos = tw.spectral_positions(n1, n2)
    passes = gl_fold_passes(field, n1, n2, device=device)
    cp1, cp2, icp2, icp1 = (passes[k] for k in ("cp1", "cp2", "icp2", "icp1"))

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

    def reshape(hl, shape):
        return tuple(v.reshape(shape) for v in hl)

    def take(hl, idx, dim):
        return tuple(v.index_select(dim, idx) for v in hl)

    def fwd2d(hl, shape):
        return cp2(cp1(reshape(hl, shape)))

    def inv2d(hl, shape):
        return icp1(icp2(reshape(hl, shape)))

    def poly2d(a, b, shape):
        return inv2d(gl_mul(fwd2d(a, shape), fwd2d(b, shape)),
                     shape[:-2] + (n2, n1))

    natural = config.ordering == "natural"
    bitrev = config.ordering == "bitrev"
    perm = torch.from_numpy(pos.astype(np.int64)).to(device)
    inv_perm_np = np.empty(n, dtype=np.int64)
    inv_perm_np[pos] = np.arange(n)
    inv_perm = torch.from_numpy(inv_perm_np).to(device)

    def fwd_fn(a):
        out = reshape(fwd2d(a, (n1, n2)), (n,))
        return take(out, perm, 0) if natural else out

    def inv_fn(a):
        a = reshape(a, (n,))
        return reshape(inv2d(take(a, inv_perm, 0) if natural else a,
                             (n2, n1)), (n,))

    def polymul_fn(a, b):
        return reshape(poly2d(a, b, (n1, n2)), (n,))

    def batched_builder(B: int) -> dict:
        bsh = (B, n1, n2)

        def fwd_b(a):
            out = reshape(fwd2d(a, bsh), (B, n))
            return take(out, perm, 1) if natural else out

        def inv_b(a):
            a = reshape(a, (B, n))
            return reshape(inv2d(take(a, inv_perm, 1) if natural else a,
                                 (B, n2, n1)), (B, n))

        out = {
            "fwd": wrap1(fwd_b),
            "inv": wrap1(inv_b),
            "polymul": wrap2(lambda a, b: reshape(poly2d(a, b, bsh), (B, n))),
            "polymul_mat": wrap2(lambda a, b: poly2d(a, b, bsh)),
        }
        if bitrev:
            out["fwd_mat"] = wrap1(lambda a: fwd2d(a, bsh))
            out["inv_mat"] = wrap1(lambda a: inv2d(a, (B, n2, n1)))
        return out

    return Plan(
        config=config,
        device=device,
        fwd=wrap1(fwd_fn),
        inv=wrap1(inv_fn),
        polymul=wrap2(polymul_fn),
        spectral_to_natural=pos,
        reduction="goldilocks",
        passes=passes,
        fwd_mat=wrap1(lambda a: fwd2d(a, (n1, n2))) if bitrev else None,
        inv_mat=wrap1(lambda a: inv2d(a, (n2, n1))) if bitrev else None,
        polymul_mat=wrap2(lambda a, b: poly2d(a, b, (n1, n2))),
        _batched_builder=batched_builder,
    )
