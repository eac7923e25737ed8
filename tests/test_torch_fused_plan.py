"""The port's fused plan (``build_plan(..., fused=True)``; CPU: the plain
fused transforms) against the reference's fused plan (Pallas kernels in
interpret mode), callable by callable, and against the NumPy oracles, the
schoolbook negacyclic product and the port's own fold plan. Bit-exact
throughout: the data are integers mod p.

This file compares the unbatched callables at (n1, n2) = (32, 32); the
batched ones (test_torch_fused_plan_batched.py) and the asymmetric split
(test_torch_fused_plan_asym*.py) run in files of their own with this
file's check, so the reference's interpret-mode compiles spread out.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu import config as jcfg
from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import plan as jplan
from ntt_aie_tpu.api import NTTContext as JContext

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch.ops import fused_fourstep as FF

P = T.P_469762049.p
B = 2
CALLABLES = ["fwd", "inv", "polymul", "negacyclic_polymul", "fwd_mat",
             "inv_mat", "polymul_mat", "negacyclic_polymul_mat"]


def _cfgs(log_n, rows_log2, **kw):
    return (jcfg.NTTConfig(field=jF.P_469762049, log_n=log_n,
                           rows_log2=rows_log2, **kw),
            T.NTTConfig(field=T.P_469762049, log_n=log_n,
                        rows_log2=rows_log2, **kw))


def _inputs(log_n, seed=0):
    rng = np.random.default_rng([log_n, seed])
    n = 1 << log_n
    return rng.integers(0, P, (B, n)), rng.integers(0, P, (B, n))


def _call(fns, name, a, b, shape, spectral):
    """Run callable `name` of `fns` (a plan or a batched dict) on the
    operands its contract takes: coefficient vectors a, b in natural
    layout, reshaped to `shape`; `spectral` is fwd's own output, for the
    inverses."""
    get = fns.get if isinstance(fns, dict) else functools.partial(getattr,
                                                                  fns)
    fn = get(name)
    if name in ("inv", "inv_mat"):
        return fn(spectral)
    if "polymul" in name:
        return fn(a.reshape(shape), b.reshape(shape))
    return fn(a.reshape(shape))


@functools.lru_cache(maxsize=None)
def reference_outputs(log_n, rows_log2, batched):
    """Every callable of the reference fused plan: unbatched on row 0, or
    batched (make_batched(2)) on both rows."""
    jc, _ = _cfgs(log_n, rows_log2, negacyclic=True)
    n1, n2 = jc.split
    jp = jplan.build_plan(jc, engine="pallas", interpret=True, fused=True)
    a, b = (jnp.asarray(v, jnp.uint32) for v in _inputs(log_n))
    if batched:
        fns, lead = jp.make_batched(B), (B,)
    else:
        fns, lead, a, b = jp, (), a[0], b[0]
    out = {}
    for name in CALLABLES:
        mat = name.endswith("_mat")
        shape = lead + ((n1, n2) if mat else (jc.n,))
        spec = out.get("fwd_mat" if mat else "fwd")
        out[name] = _call(fns, name, a, b, shape, spec)
    return {k: np.asarray(v).astype(np.int64) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def port_plan(log_n, rows_log2, **kw):
    return T.build_plan(_cfgs(log_n, rows_log2, **kw)[1], device="cpu",
                        fused=True)


def check_callable(log_n, rows_log2, name, batched):
    want = reference_outputs(log_n, rows_log2, batched)
    plan = port_plan(log_n, rows_log2, negacyclic=True)
    n1, n2 = plan.config.split
    a, b = (torch.from_numpy(v) for v in _inputs(log_n))
    if batched:
        fns, lead = plan.make_batched(B), (B,)
    else:
        fns, lead, a, b = plan, (), a[0], b[0]
    mat = name.endswith("_mat")
    shape = lead + ((n1, n2) if mat else (plan.config.n,))
    spec = torch.from_numpy(want["fwd_mat" if mat else "fwd"])
    got = _call(fns, name, a, b, shape, spec)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == want[name].shape
    assert np.array_equal(got.numpy().astype(np.int64), want[name])


@pytest.mark.parametrize("name", CALLABLES)
def test_fused_plan_matches_reference_plan(name):
    check_callable(10, 5, name, batched=False)


def test_negacyclic_matches_schoolbook():
    plan = port_plan(10, 5, negacyclic=True)
    a, b = _inputs(10, seed=3)
    want = ref.schoolbook_negacyclic(a[0], b[0], P)
    got = plan.negacyclic_polymul(a[0], b[0]).numpy()
    assert np.array_equal(got.astype(object), want)
    assert np.array_equal(got, ref.negacyclic_polymul(a[0], b[0],
                                                      T.P_469762049))


def test_negacyclic_oracles_match_native():
    from ntt_aie_tpu_torch import native_oracle

    f = T.P_469762049
    a, b = _inputs(10, seed=4)
    psi = f.root_of_unity(2 * len(a[0]))
    assert np.array_equal(
        native_oracle.negacyclic_polymul(a[0], b[0], psi, P).astype(np.int64),
        ref.negacyclic_polymul(a[0], b[0], f))


@pytest.mark.parametrize("log_n,rows_log2", [(16, 8), (20, 10)])
def test_fused_equals_fold_plan(log_n, rows_log2):
    _, tc = _cfgs(log_n, rows_log2)
    fold = T.build_plan(tc, device="cpu")
    fused = T.build_plan(tc, device="cpu", fused=True)
    assert set(fused.passes) == {"ff", "fi"}
    a, _ = _inputs(log_n, seed=5)
    f = fused.fwd(a[0])
    assert torch.equal(f, fold.fwd(a[0]))
    assert torch.equal(fused.inv(f), fold.inv(f))
    n1, n2 = tc.split
    x = torch.from_numpy(a[:1].reshape(1, n1, n2))
    assert torch.equal(fused.make_batched(1)["fwd_mat"](x),
                       fold.make_batched(1)["fwd_mat"](x))


def test_fused_plan_passes():
    """The fused plan holds the fused transforms under the reference's
    names, psi^i as nf's 'pre' and psi^-i as ni's 'post', and no column
    pass (the card checks that no column pass launches)."""
    plan = port_plan(10, 5, negacyclic=True)
    assert set(plan.passes) == {"ff", "fi", "nf", "ni"}
    assert all(isinstance(v, FF.FusedFourstep) for v in plan.passes.values())
    assert plan.passes["nf"].pre is not None and plan.passes["nf"].post is None
    assert plan.passes["ni"].post is not None and plan.passes["ni"].pre is None
    assert not plan.passes["ff"].inverse and plan.passes["fi"].inverse


def test_context_negacyclic_errors_match_reference():
    jc, tc = _cfgs(10, 5)
    a, b = _inputs(10, seed=7)
    with pytest.raises(ValueError) as jerr:
        JContext(jc, fused=True).negacyclic_polymul(a[0], b[0])
    with pytest.raises(ValueError) as terr:
        T.NTTContext(tc, device="cpu", fused=True).negacyclic_polymul(
            a[0], b[0])
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(NotImplementedError):
        T.NTTContext(tc, device="cpu", fused=True).negacyclic_polymul_mat(
            a[0].reshape(32, 32), b[0].reshape(32, 32))
    _, nc = _cfgs(10, 5, negacyclic=True)
    ctx = T.NTTContext(nc, device="cpu", fused=True)
    plan = port_plan(10, 5, negacyclic=True)
    assert torch.equal(ctx.negacyclic_polymul(a[0], b[0]),
                       plan.negacyclic_polymul(a[0], b[0]))
    assert torch.equal(
        ctx.negacyclic_polymul_mat(a[0].reshape(32, 32), b[0].reshape(32, 32)),
        plan.negacyclic_polymul_mat(a[0].reshape(32, 32),
                                    b[0].reshape(32, 32)))


def test_unported_fused_configs_raise():
    """The configurations that raised here before: the negacyclic product
    without fused=True (4d), now the fold plan's (ncp1/nicp1), equal to the
    fused plan's; and fused with wmat_factored=True (4g), which keeps the
    fused kernels and records wmat_factored as the reference does."""
    _, nc = _cfgs(11, 4, negacyclic=True)
    fold = T.build_plan(nc, device="cpu")
    assert {"ncp1", "nicp1"} <= set(fold.passes)
    a, b = _inputs(11)
    want = port_plan(11, 4, negacyclic=True).negacyclic_polymul(a[0], b[0])
    assert torch.equal(fold.negacyclic_polymul(a[0], b[0]), want)
    assert torch.equal(
        T.NTTContext(nc, device="cpu").negacyclic_polymul(a[0], b[0]), want)
    fac = T.build_plan(nc, device="cpu", fused=True, wmat_factored=True)
    assert set(fac.passes) == {"ff", "fi", "nf", "ni"}
    assert (fac.wmat_factored, fac.wmat_fold) == (True, False)
    assert torch.equal(fac.negacyclic_polymul(a[0], b[0]), want)
