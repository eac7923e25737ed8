"""The port's reference-parity mode (NTTConfig(table_convention=
'reference')) against the reference's, bit for bit, on the CPU: the
reference device's butterfly network with the natural-order power table
and its 16-block layout (the reference's ``_build_reference_plan``, XLA,
no Pallas kernel), the NumPy network of ``ntt_aie_tpu.reference``, the
native C++ one, and ``reference_device_output``. Inputs come from a numpy
seed, or are the paper's a[i] = i."""

import functools

import numpy as np
import pytest
import torch

from ntt_aie_tpu import api as japi
from ntt_aie_tpu import config as jcfg
from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import native_oracle as jnative
from ntt_aie_tpu import plan as jplan
from ntt_aie_tpu import reference as jref
from ntt_aie_tpu import twiddles as jtw

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import native_oracle
from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.ops import reductions as R
from ntt_aie_tpu_torch.ops import stages as S


def _cfgs(name, log_n, ordering):
    kw = dict(log_n=log_n, table_convention="reference", ordering=ordering)
    return (jcfg.NTTConfig(field=jF.FIELDS[name], **kw),
            T.NTTConfig(field=T.FIELDS[name], **kw))


@functools.lru_cache(maxsize=None)
def _jax_fwd(name, log_n, ordering, seed):
    jc, _ = _cfgs(name, log_n, ordering)
    a = _input(name, log_n, seed)
    return np.asarray(jplan.build_plan(jc).fwd(a)).astype(np.int64)


def _input(name, log_n, seed):
    if seed is None:
        return np.arange(1 << log_n)
    return np.random.default_rng([log_n, seed]).integers(
        0, T.FIELDS[name].p, 1 << log_n)


@pytest.mark.parametrize("ordering", ["reference", "bitrev"])
def test_kyber_parity(ordering):
    """The paper's configuration (p = 3329, n = 2048, a[i] = i): the
    port's fwd equals the reference plan's and its NumPy network; under
    ordering='reference' it is reference_device_output and the native
    network with block_permute16."""
    _, tc = _cfgs("kyber", 11, ordering)
    a = np.arange(2048)
    plan = T.build_plan(tc, device="cpu")
    got = plan.fwd(a)
    assert got.dtype == torch.int32 and got.shape == (2048,)
    got = got.numpy().astype(np.int64)
    assert np.array_equal(got, _jax_fwd("kyber", 11, ordering, None))
    table = jtw.power_table(jF.KYBER, 2048)
    want = jref.reference_network(a, table, 3329)
    if ordering == "reference":
        want = jref.block_permute(want)
        assert np.array_equal(got,
                              jref.reference_device_output(a, jF.KYBER, 2048))
        native = native_oracle.block_permute16(native_oracle.reference_network(
            a, native_oracle.make_power_table(2048, 3329, 3), 3329))
        assert np.array_equal(got, native)
    assert np.array_equal(got, want)
    assert plan.reduction == "barrett"


@pytest.mark.parametrize("stages", [0, 3, 10])
def test_partial_depth(stages):
    """reference_network_stages(stages=s) runs stages 0..s: the
    reference's NumPy network at that depth, on Kyber's table."""
    field = T.KYBER
    red = R.make_reduction("barrett", field)
    table = tuple(torch.from_numpy(t.astype(np.int64))
                  for t in red.prepare_table(tw.power_table(field, 2048)))
    a = _input("kyber", 11, stages)
    got = S.reference_network_stages(torch.from_numpy(a), table, red,
                                     stages=stages)
    want = jref.reference_network(a, jtw.power_table(jF.KYBER, 2048),
                                  field.p, stages=stages)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ref.reference_network(
        a, tw.power_table(field, 2048), field.p, stages=stages), want)
    assert np.array_equal(native_oracle.reference_network(
        a, tw.power_table(field, 2048), field.p, stages=stages), want)


@pytest.mark.parametrize("name,kind", [("p469762049", "harvey4"),
                                       ("p998244353", "harvey"),
                                       ("p2013265921", "montgomery")])
def test_other_reductions(name, kind):
    """The lazy reductions differ in raw bits between stages; the
    canonical output equals the reference plan's and the NumPy network."""
    _, tc = _cfgs(name, 10, "bitrev")
    plan = T.build_plan(tc, device="cpu")
    assert plan.reduction == kind
    a = _input(name, 10, 1)
    got = plan.fwd(torch.from_numpy(a)).numpy().astype(np.int64)
    assert np.array_equal(got, _jax_fwd(name, 10, "bitrev", 1))
    field = T.FIELDS[name]
    assert np.array_equal(got, ref.reference_network(
        a, tw.power_table(field, 1024), field.p))


def test_small_network_scalar_crosscheck():
    """The vectorized network against the scalar transcription of the
    reference's loops, at every depth of n = 64."""
    field = T.P_469762049
    a = _input("p469762049", 6, 2)
    table = tw.power_table(field, 64)
    for s in range(6):
        want = jref.reference_network_scalar(a, table, field.p, s)
        assert np.array_equal(ref.reference_network_scalar(
            a, table, field.p, s), want)
        assert np.array_equal(ref.reference_network(a, table, field.p,
                                                    stages=s), want)


def test_refusals_match_reference():
    """Goldilocks has no reduction (ValueError, as the reference's
    make_reduction); the plan has no inverse, no product and no batched
    path, and its order and negacyclic product are None, as the
    reference's."""
    gl = dict(field=T.GOLDILOCKS, log_n=10, table_convention="reference")
    with pytest.raises(ValueError, match="unknown reduction kind"):
        T.build_plan(T.NTTConfig(**gl), device="cpu")
    with pytest.raises(ValueError, match="unknown reduction kind"):
        jplan.build_plan(jcfg.NTTConfig(**dict(gl, field=jF.GOLDILOCKS)))
    jc, tc = _cfgs("kyber", 11, "reference")
    plan, jp = T.build_plan(tc, device="cpu"), jplan.build_plan(jc)
    a = np.arange(2048)
    for p in (plan, jp):
        for fn in (p.inv, lambda v: p.polymul(v, v)):
            with pytest.raises(NotImplementedError, match="no inverse"):
                fn(a)
        with pytest.raises(NotImplementedError, match="no batched path"):
            p.make_batched(4)
        assert p.spectral_to_natural is None
        assert p.negacyclic_polymul is None and p.fwd_mat is None


@pytest.mark.parametrize("ordering", ["reference", "bitrev"])
def test_context_forward_host(ordering):
    """NTTContext.forward_host takes the reference branch: power_table,
    reference_network, block_permute under ordering='reference'; forward
    runs the plan; inverse_host raises."""
    jc, tc = _cfgs("kyber", 11, ordering)
    a = _input("kyber", 11, 5)
    ctx = T.NTTContext(tc, device="cpu")
    want = japi.NTTContext(jc).forward_host(a)
    assert np.array_equal(ctx.forward_host(a), want)
    assert np.array_equal(ctx.forward(a).numpy(), want)
    with pytest.raises(NotImplementedError, match="no inverse"):
        ctx.inverse_host(want)


def test_native_bindings_match_reference():
    """The port's jax-free ctypes bindings of the parity entry points and
    the schoolbook product equal the reference's."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 3329, 256)
    b = rng.integers(0, 3329, 256)
    table = native_oracle.make_power_table(256, 3329, 3)
    assert np.array_equal(table, jnative.make_power_table(256, 3329, 3))
    assert np.array_equal(native_oracle.reference_network(a, table, 3329, 4),
                          jnative.reference_network(a, table, 3329, 4))
    assert np.array_equal(native_oracle.block_permute16(a),
                          jnative.block_permute16(a))
    assert np.array_equal(native_oracle.schoolbook_negacyclic(a, b, 3329),
                          jnative.schoolbook_negacyclic(a, b, 3329))
