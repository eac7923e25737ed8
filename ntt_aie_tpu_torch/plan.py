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
plain PyTorch version on the CPU). ``fused=True`` runs each transform as
one fused four-step launch instead (``ops.fused_fourstep``: ``ff`` forward,
``fi`` inverse), with the same outputs bit for bit; only that plan has the
negacyclic product (X^N + 1), whose psi^i and psi^-i scalings ride the
fused kernels as ``pre`` (``nf``) and ``post`` (``ni``). The flat forward
output is in the four-step spectral order flat[c*N1 + r] =
X[s2(c)*N1 + s1(r)] (``twiddles.spectral_positions``); pointwise products
are order-agnostic, so polymul never permutes.

Every reduction of ``ops.reductions`` runs both plans (harvey4, harvey,
montgomery, barrett; ``NTTConfig.reduction``, 'auto' by the prime). The
pointwise product is ``Reduction.mul_data``, the exact canonical product
for every kind, so the polymul inverse is the plain inverse. (The
reference's montgomery product is one REDC, which leaves an R^-1 that its
polymul inverse takes back with iwmat_poly; the canonical outputs are the
same.)

Public tensors are ``torch.int32`` holding values in [0, p). Goldilocks
configurations route to ``goldilocks_plan.build_goldilocks_plan``, which
returns the same ``Plan`` over (hi, lo) limb planes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.config import NTTConfig
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops.colpass import make_colpass
from ntt_aie_tpu_torch.ops.fused_fourstep import make_fused_fourstep
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
    exist with NTTConfig(negacyclic=True) on a fused plan, else None.
    make_batched(B) returns the same callables over a leading batch axis.
    passes holds the four column passes (cp1, cp2, icp2, icp1), or on a
    fused plan the fused transforms (ff, fi, and nf, ni for negacyclic).
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
    _batched_builder: Optional[Callable] = None
    _batched_cache: dict = dataclasses.field(default_factory=dict)

    def make_batched(self, batch: int) -> dict:
        if batch not in self._batched_cache:
            self._batched_cache[batch] = self._batched_builder(batch)
        return self._batched_cache[batch]


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md {item}")


def fold_passes(field, n1: int, n2: int, *, reduction: str = "harvey4",
                device=None) -> dict:
    """The four column passes of the four-step fold plan for an (n1, n2)
    split under the reduction of this kind (reference plan.py:275-293):
    cp1 and icp1 over (.., n1, n2), cp2 and icp2 over (.., n2, n1). The
    four-step multiply rides the transposing passes' exit as 'post_t',
    with its operand in output orientation: wmat.T for cp1, iwmat_scaled
    (1/n folded in) for icp2. device: None is the card
    (utils.device.resolve_device)."""
    device = resolve_device(device)
    tabs = tw.fourstep_tables(field, n1, n2)
    kw = dict(reduction=reduction, device=device)
    return {
        "cp1": make_colpass(field, n1, direction="dif", transpose_out=True,
                            wmat=np.ascontiguousarray(tabs["wmat"].T), **kw),
        "cp2": make_colpass(field, n2, direction="dif", canonicalize=True,
                            **kw),
        "icp2": make_colpass(field, n2, direction="dit", inverse_tw=True,
                             transpose_out=True, wmat=tabs["iwmat_scaled"],
                             **kw),
        "icp1": make_colpass(field, n1, direction="dit", inverse_tw=True,
                             canonicalize=True, **kw),
    }


def fused_passes(field, n1: int, n2: int, *, negacyclic: bool = False,
                 reduction: str = "harvey4", device=None) -> dict:
    """The fused transforms of the fused plan for an (n1, n2) split under
    the reduction of this kind (reference plan.py:328-336, :685-689): ff
    over (.., n1, n2) with wmid = wmat.T, fi over (.., n2, n1) with wmid =
    iwmat_scaled (1/n folded in; the polymul inverse too), and with
    negacyclic nf = ff with psi^i as 'pre', ni = fi with psi^-i as
    'post'. device: None is the card."""
    device = resolve_device(device)
    tabs = tw.fourstep_tables(field, n1, n2)
    wmid_fwd = np.ascontiguousarray(tabs["wmat"].T)
    kw = dict(reduction=reduction, device=device)
    out = {
        "ff": make_fused_fourstep(field, n1, n2, wmid=wmid_fwd, **kw),
        "fi": make_fused_fourstep(field, n1, n2, inverse=True,
                                  wmid=tabs["iwmat_scaled"], **kw),
    }
    if negacyclic:
        n = n1 * n2
        out["nf"] = make_fused_fourstep(
            field, n1, n2, wmid=wmid_fwd,
            pre=tw.negacyclic_psi_powers(field, n).reshape(n1, n2), **kw)
        out["ni"] = make_fused_fourstep(
            field, n1, n2, inverse=True, wmid=tabs["iwmat_scaled"],
            post=tw.negacyclic_psi_powers(field, n,
                                          inverse=True).reshape(n1, n2),
            **kw)
    return out


def build_plan(config: NTTConfig, *, device=None, fused: bool = False,
               wmat_factored: bool | None = None,
               wmat_fold: bool | None = None) -> Plan:
    """Build the four-step plan of `config` on `device`: the fold plan, or
    with fused=True the fused plan (for Goldilocks, build_goldilocks_plan's
    fold plan; `fused` does not apply there, as in the reference).

    Tables are prepared once here, on the plan's device: the card when
    device is None (RuntimeError without one; device="cpu" runs the plain
    PyTorch version). Configurations outside the ported slice raise NotImplementedError naming the
    ROADMAP.md item that ports them.
    """
    field = config.field
    if config.table_convention == "reference":
        _not_ported("the reference-parity convention", "Queue 1 item 4j")
    kind = resolve_kind(config.reduction, field)
    if kind == "goldilocks":
        from ntt_aie_tpu_torch.goldilocks_plan import build_goldilocks_plan

        return build_goldilocks_plan(config, device=device,
                                     wmat_factored=wmat_factored,
                                     wmat_fold=wmat_fold)
    red = make_reduction(kind, field)
    n1, n2 = config.split
    if n2 == 1:
        _not_ported(f"the flat split {config.split} (pin rows_log2 for a "
                    "four-step plan)", "Queue 1 item 4h")
    if config.negacyclic and not fused:
        _not_ported("negacyclic polymul on the two-pass plan (build_plan("
                    "..., fused=True) has it)", "Queue 1 item 4d")
    if wmat_factored:
        _not_ported("wmat_factored=True", "Queue 1 item 4g")
    if wmat_fold is False:
        _not_ported("wmat_fold=False", "Queue 1 item 4g")
    if config.num_shards != 1:
        _not_ported("the distributed plan", "Queue 1 item 10")

    device = resolve_device(device)
    n = config.n
    pos = tw.spectral_positions(n1, n2)
    if fused:
        passes = fused_passes(field, n1, n2, negacyclic=config.negacyclic,
                              reduction=kind, device=device)
        fwd_t, inv_t = passes["ff"], passes["fi"]
    else:
        passes = fold_passes(field, n1, n2, reduction=kind, device=device)
        cp1, cp2, icp2, icp1 = (passes[k]
                                for k in ("cp1", "cp2", "icp2", "icp1"))

        def fwd_t(x):
            return cp2(cp1(x))

        def inv_t(x):
            return icp1(icp2(x))

    def as_i32(a) -> torch.Tensor:
        return torch.as_tensor(a, device=device).to(torch.int32)

    def pointwise(fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
        return M.from_carrier(red.mul_data(M.to_carrier(fa),
                                           M.to_carrier(fb)))

    def fwd2d(a, shape):
        return fwd_t(as_i32(a).reshape(shape))

    def inv2d(a, shape):
        return inv_t(as_i32(a).reshape(shape))

    def poly2d(a, b, shape):
        return inv2d(pointwise(fwd2d(a, shape), fwd2d(b, shape)),
                     shape[:-2] + (n2, n1))

    nega2d = None
    if config.negacyclic:
        nf, ni = passes["nf"], passes["ni"]

        def nega2d(a, b, shape):
            fa = nf(as_i32(a).reshape(shape))
            fb = nf(as_i32(b).reshape(shape))
            return ni(pointwise(fa, fb))

    natural = config.ordering == "natural"
    perm = torch.from_numpy(pos.astype(np.int64)).to(device)
    inv_perm_np = np.empty(n, dtype=np.int64)
    inv_perm_np[pos] = np.arange(n)
    inv_perm = torch.from_numpy(inv_perm_np).to(device)

    def fwd_fn(a):
        out = fwd2d(a, (n1, n2)).reshape(n)
        return out[perm] if natural else out

    def inv_fn(a):
        a = as_i32(a)
        return inv2d(a[inv_perm] if natural else a, (n2, n1)).reshape(n)

    def polymul_fn(a, b):
        return poly2d(a, b, (n1, n2)).reshape(n)

    def batched_builder(B: int) -> dict:
        bsh = (B, n1, n2)

        def fwd_b(a):
            out = fwd2d(a, bsh).reshape(B, n)
            return out[:, perm] if natural else out

        def inv_b(a):
            a = as_i32(a).reshape(B, n)
            return inv2d(a[:, inv_perm] if natural else a,
                         (B, n2, n1)).reshape(B, n)

        out = {
            "fwd": fwd_b,
            "inv": inv_b,
            "polymul": lambda a, b: poly2d(a, b, bsh).reshape(B, n),
            "polymul_mat": lambda a, b: poly2d(a, b, bsh),
        }
        if not natural:
            out["fwd_mat"] = lambda a: fwd2d(a, bsh)
            out["inv_mat"] = lambda a: inv2d(a, (B, n2, n1))
        if nega2d is not None:
            out["negacyclic_polymul"] = (
                lambda a, b: nega2d(a, b, bsh).reshape(B, n))
            out["negacyclic_polymul_mat"] = lambda a, b: nega2d(a, b, bsh)
        return out

    return Plan(
        config=config,
        device=device,
        fwd=fwd_fn,
        inv=inv_fn,
        polymul=polymul_fn,
        spectral_to_natural=pos,
        reduction=kind,
        passes=passes,
        fwd_mat=None if natural else (lambda a: fwd2d(a, (n1, n2))),
        inv_mat=None if natural else (lambda a: inv2d(a, (n2, n1))),
        polymul_mat=lambda a, b: poly2d(a, b, (n1, n2)),
        negacyclic_polymul=(None if nega2d is None else
                            lambda a, b: nega2d(a, b, (n1, n2)).reshape(n)),
        negacyclic_polymul_mat=(None if nega2d is None else
                                lambda a, b: nega2d(a, b, (n1, n2))),
        _batched_builder=batched_builder,
    )
