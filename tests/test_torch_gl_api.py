"""The port's Goldilocks plan through its other entry points: the
unbatched callables against the reference Goldilocks plan (Pallas kernels
in interpret mode), every callable against the port's object-dtype NumPy
oracle, natural ordering, NTTContext, and the configurations that are not
ported yet. Bit-exact throughout."""

import functools

import numpy as np
import pytest
import torch

from ntt_aie_tpu import config as jcfg
from ntt_aie_tpu import fields as jF
from ntt_aie_tpu.goldilocks_plan import build_goldilocks_plan as j_build

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch.ops import modops as tM

GL = T.GOLDILOCKS
P = GL.p


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version runs thousands of small int64 ops; under the
    suite's parallel workers an intra-op thread pool per worker only
    contends for the cores, so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(log_n, seed, rows=2):
    rng = np.random.default_rng([log_n, seed])
    return rng.integers(0, 1 << 64, (rows, 1 << log_n),
                        dtype=np.uint64) % np.uint64(P)


@functools.lru_cache(maxsize=None)
def _port_plan(log_n, rows_log2, ordering="bitrev"):
    return T.build_plan(T.NTTConfig(field=GL, log_n=log_n,
                                    rows_log2=rows_log2, ordering=ordering),
                        device="cpu")


@functools.lru_cache(maxsize=None)
def _reference_unbatched():
    jc = jcfg.NTTConfig(field=jF.GOLDILOCKS, log_n=10, rows_log2=4)
    n1, n2 = jc.split
    jp = j_build(jc, engine="pallas", interpret=True)
    a, b = _rand(10, 1)
    out = {"fwd_mat": jp.fwd_mat(a.reshape(n1, n2)), "fwd": jp.fwd(a),
           "polymul": jp.polymul(a, b),
           "polymul_mat": jp.polymul_mat(a.reshape(n1, n2),
                                         b.reshape(n1, n2))}
    out["inv_mat"] = jp.inv_mat(out["fwd_mat"])
    out["inv"] = jp.inv(out["fwd"])
    return {k: np.asarray(v, dtype=np.uint64) for k, v in out.items()}


@pytest.mark.parametrize("fn", ["fwd_mat", "inv_mat", "polymul_mat", "fwd",
                                "inv", "polymul"])
def test_unbatched_matches_reference_plan(fn):
    want = _reference_unbatched()
    plan = _port_plan(10, 4)
    n1, n2 = plan.config.split
    a, b = _rand(10, 1)
    args = {"fwd_mat": (a.reshape(n1, n2),), "inv_mat": (want["fwd_mat"],),
            "polymul_mat": (a.reshape(n1, n2), b.reshape(n1, n2)),
            "fwd": (a,), "inv": (want["fwd"],), "polymul": (a, b)}[fn]
    got = getattr(plan, fn)(*args)
    assert got.dtype == np.uint64 and np.array_equal(got, want[fn])
    pair = getattr(plan, fn)(*(tM.gl_from_u64(v, "cpu") for v in args))
    assert np.array_equal(tM.gl_to_u64(*pair), want[fn])


@pytest.mark.parametrize("log_n,rows_log2", [(16, 8), (12, 8), (10, 4)])
def test_against_object_oracle(log_n, rows_log2):
    plan = _port_plan(log_n, rows_log2)
    n1, n2 = plan.config.split
    x = _rand(log_n, 2)
    a0, b0 = x
    nat = ref.ntt_forward(a0, GL)
    assert nat.dtype == object
    flat = plan.fwd(a0)
    assert np.array_equal(flat[plan.spectral_to_natural].astype(object), nat)
    assert np.array_equal(plan.inv(flat), a0)
    want_c = ref.cyclic_polymul(a0, b0, GL)
    assert np.array_equal(plan.polymul(a0, b0).astype(object), want_c)
    fm = plan.fwd_mat(a0.reshape(n1, n2))
    assert fm.shape == (n2, n1) and np.array_equal(fm.ravel(), flat)
    assert np.array_equal(plan.inv_mat(fm), a0.reshape(n1, n2))
    pm = plan.polymul_mat(a0.reshape(n1, n2), b0.reshape(n1, n2))
    assert np.array_equal(pm.ravel().astype(object), want_c)


def test_natural_ordering():
    plan = _port_plan(12, 8, ordering="natural")
    assert plan.fwd_mat is None and plan.inv_mat is None
    a, b = _rand(12, 3), _rand(12, 6)
    want = np.stack([ref.ntt_forward(r, GL) for r in a])
    assert np.array_equal(plan.fwd(a[0]).astype(object), want[0])
    assert np.array_equal(plan.inv(want[0].astype(np.uint64)), a[0])
    bat = plan.make_batched(2)
    assert "fwd_mat" not in bat and "inv_mat" not in bat
    got = bat["fwd"](a)
    assert np.array_equal(got.astype(object), want)
    assert np.array_equal(bat["inv"](got), a)
    # polymul is order-agnostic
    assert np.array_equal(bat["polymul"](a, b)[1].astype(object),
                          ref.cyclic_polymul(a[1], b[1], GL))


def test_limb_pair_and_uint64_interfaces_agree():
    plan = _port_plan(10, 4)
    a = _rand(10, 4)[0]
    hl = tM.gl_from_u64(a, "cpu")
    out = plan.fwd(hl)
    assert isinstance(out, tuple)
    assert all(v.dtype == torch.int32 and tuple(v.shape) == (1 << 10,)
               for v in out)
    assert np.array_equal(tM.gl_to_u64(*out), plan.fwd(a))
    with pytest.raises(TypeError):
        plan.fwd((hl[0].long(), hl[1].long()))


@pytest.mark.parametrize("ordering", ["bitrev", "natural"])
def test_context_serves_goldilocks(ordering):
    from ntt_aie_tpu.api import NTTContext as JContext

    tc = T.NTTConfig(field=GL, log_n=12, rows_log2=8, ordering=ordering)
    jc = jcfg.NTTConfig(field=jF.GOLDILOCKS, log_n=12, rows_log2=8,
                        ordering=ordering)
    ctx = T.NTTContext(tc, device="cpu")
    assert ctx.plan.reduction == "goldilocks"
    a, b = _rand(12, 5), _rand(12, 7)
    host = ctx.forward_host(a[0])
    assert np.array_equal(host, JContext(jc).forward_host(a[0]))
    assert np.array_equal(ctx.inverse_host(host), a[0])
    assert np.array_equal(ctx.forward(a[0]).astype(object), host)
    assert np.array_equal(ctx.inverse(ctx.forward(a[0])), a[0])
    assert np.array_equal(ctx.polymul(a[0], b[0]).astype(object),
                          ref.cyclic_polymul(a[0], b[0], GL))
    if ordering == "bitrev":
        n1, n2 = tc.split
        fm = ctx.forward_mat(a[0].reshape(n1, n2))
        assert np.array_equal(fm.ravel().astype(object), host)
        assert np.array_equal(ctx.make_batched(2)["fwd_mat"](
            a.reshape(2, n1, n2))[0], fm)


@pytest.mark.parametrize("kw,build_kw", [
    ({"log_n": 12, "rows_log2": 6}, {"wmat_factored": True}),
    ({"log_n": 12, "rows_log2": 6}, {"wmat_fold": False}),
])
def test_goldilocks_arms_build(kw, build_kw):
    """The factored and entry arms, which raised before they were
    ported, through the context: the object-dtype oracle's transform and
    product (tests/test_torch_gl_arms.py holds them against the fold plan
    on every callable)."""
    cfg = T.NTTConfig(field=GL, **kw)
    ctx = T.NTTContext(cfg, device="cpu", **build_kw)
    assert ctx.plan.wmat_fold is False
    assert ctx.plan.wmat_factored == build_kw.get("wmat_factored", False)
    rng = np.random.default_rng(cfg.log_n)
    a, b = (rng.integers(0, 1 << 64, cfg.n, dtype=np.uint64)
            % np.uint64(GL.p) for _ in range(2))
    f = ctx.forward(a)
    assert np.array_equal(f, ctx.forward_host(a).astype(np.uint64))
    assert np.array_equal(ctx.inverse(f), a)
    assert np.array_equal(ctx.polymul(a, b).astype(object),
                          ref.cyclic_polymul(a, b, GL))


@pytest.mark.parametrize("rows_log2", [None, 6])
def test_goldilocks_flat_and_negacyclic_match_oracle(rows_log2):
    """The flat split (rows_log2 None: n = 2^12 runs flat) and the
    negacyclic product, which raised before they were ported, against
    the object-dtype NumPy oracles (tests/test_torch_gl_flat.py holds
    them against the reference's XLA plans)."""
    cfg = T.NTTConfig(field=GL, log_n=12, rows_log2=rows_log2,
                      negacyclic=True)
    plan = T.build_plan(cfg, device="cpu")
    a, b = _rand(12, 0)
    got = plan.fwd(a)
    assert np.array_equal(got.astype(object)[plan.spectral_to_natural],
                          ref.ntt_forward(a, GL))
    assert np.array_equal(plan.inv(got), a)
    assert np.array_equal(plan.negacyclic_polymul(a, b).astype(object),
                          ref.negacyclic_polymul(a, b, GL))
