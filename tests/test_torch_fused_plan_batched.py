"""The port's fused plan against the reference's fused plan: the batched
callables (make_batched(2)) at (n1, n2) = (32, 32), and the natural
ordering; see test_torch_fused_plan.py, whose check this file runs."""

import numpy as np
import pytest
import jax.numpy as jnp

from ntt_aie_tpu import plan as jplan

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import reference as ref
from test_torch_fused_plan import B, CALLABLES, _cfgs, _inputs, \
    check_callable


@pytest.mark.parametrize("name", CALLABLES)
def test_fused_plan_matches_reference_plan_batched(name):
    check_callable(10, 5, name, batched=True)


def test_fused_plan_natural_ordering_matches_reference():
    jc, tc = _cfgs(10, 5, ordering="natural")
    jp = jplan.build_plan(jc, engine="pallas", interpret=True, fused=True)
    tp = T.build_plan(tc, device="cpu", fused=True)
    assert tp.fwd_mat is None and tp.inv_mat is None
    a, _ = _inputs(10, seed=2)
    jb, tb = jp.make_batched(B), tp.make_batched(B)
    assert "fwd_mat" not in tb
    want = np.asarray(jp.fwd(jnp.asarray(a[0], jnp.uint32))).astype(np.int64)
    assert np.array_equal(tp.fwd(a[0]).numpy(), want)
    assert np.array_equal(tp.fwd(a[0]).numpy(),
                          ref.ntt_forward(a[0], T.P_469762049))
    assert np.array_equal(
        tp.inv(want).numpy(),
        np.asarray(jp.inv(jnp.asarray(want, jnp.uint32))))
    want_b = np.asarray(jb["fwd"](jnp.asarray(a, jnp.uint32))).astype(np.int64)
    assert np.array_equal(tb["fwd"](a).numpy(), want_b)
    assert np.array_equal(
        tb["inv"](want_b).numpy(),
        np.asarray(jb["inv"](jnp.asarray(want_b, jnp.uint32))))
    assert np.array_equal(tb["inv"](want_b).numpy(), a)
