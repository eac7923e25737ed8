"""The port's four-step fold plan (CPU: plain column passes) against the
reference plan (Pallas kernels in interpret mode) and the NumPy oracles.
Bit-exact throughout: the data are integers mod p."""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu import config as jcfg
from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import plan as jplan

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import reference as ref

P = T.P_469762049.p
# (log_n, rows_log2): nested columns both ways, nested unequal, plain
CONFIGS = [(16, 8), (17, 8), (11, 4)]
B = 2


def _cfgs(log_n, rows_log2, **kw):
    return (jcfg.NTTConfig(field=jF.P_469762049, log_n=log_n,
                           rows_log2=rows_log2, **kw),
            T.NTTConfig(field=T.P_469762049, log_n=log_n,
                        rows_log2=rows_log2, **kw))


def _inputs(log_n, seed=0):
    rng = np.random.default_rng([log_n, seed])
    n = 1 << log_n
    return rng.integers(0, P, (B, n)), rng.integers(0, P, (B, n))


@functools.lru_cache(maxsize=None)
def _reference_outputs(log_n, rows_log2):
    jc, _ = _cfgs(log_n, rows_log2)
    n1, n2 = jc.split
    jb = jplan.build_plan(jc, engine="pallas",
                          interpret=True).make_batched(B)
    a, b = _inputs(log_n)
    am, bm = (jnp.asarray(v.reshape(B, n1, n2), jnp.uint32) for v in (a, b))
    af, bf = (jnp.asarray(v, jnp.uint32) for v in (a, b))
    out = {
        "fwd_mat": jb["fwd_mat"](am),
        "polymul_mat": jb["polymul_mat"](am, bm),
        "fwd": jb["fwd"](af),
        "polymul": jb["polymul"](af, bf),
    }
    out["inv_mat"] = jb["inv_mat"](out["fwd_mat"])
    out["inv"] = jb["inv"](out["fwd"])
    return {k: np.asarray(v).astype(np.int64) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _port_plan(log_n, rows_log2, ordering="bitrev"):
    return T.build_plan(_cfgs(log_n, rows_log2, ordering=ordering)[1],
                        device="cpu")


def _np(t):
    assert t.dtype == torch.int32
    return t.numpy().astype(np.int64)


@pytest.mark.parametrize("log_n,rows_log2", CONFIGS)
@pytest.mark.parametrize("fn", ["fwd_mat", "inv_mat", "polymul_mat", "fwd",
                                "inv", "polymul"])
def test_batched_matches_reference_plan(log_n, rows_log2, fn):
    want = _reference_outputs(log_n, rows_log2)
    plan = _port_plan(log_n, rows_log2)
    n1, n2 = plan.config.split
    a, b = (torch.from_numpy(v) for v in _inputs(log_n))
    bat = plan.make_batched(B)
    assert plan.make_batched(B) is bat
    if fn == "fwd_mat":
        got = bat[fn](a.reshape(B, n1, n2))
        assert tuple(got.shape) == (B, n2, n1)
    elif fn == "inv_mat":
        got = bat[fn](torch.from_numpy(want["fwd_mat"]))
        assert tuple(got.shape) == (B, n1, n2)
    elif fn == "polymul_mat":
        got = bat[fn](a.reshape(B, n1, n2), b.reshape(B, n1, n2))
    elif fn == "inv":
        got = bat[fn](torch.from_numpy(want["fwd"]))
    elif fn == "polymul":
        got = bat[fn](a, b)
    else:
        got = bat[fn](a)
    assert np.array_equal(_np(got), want[fn])


@pytest.mark.parametrize("log_n,rows_log2", CONFIGS)
def test_against_numpy_oracles(log_n, rows_log2):
    plan = _port_plan(log_n, rows_log2)
    n1, n2 = plan.config.split
    a, b = _inputs(log_n, seed=1)
    a0, b0 = a[0], b[0]
    nat = ref.ntt_forward(a0, T.P_469762049)
    # flat spectral order: natural[k] = flat[pos[k]]
    flat = _np(plan.fwd(torch.from_numpy(a0)))
    assert np.array_equal(flat[plan.spectral_to_natural], nat)
    assert np.array_equal(_np(plan.inv(torch.from_numpy(flat))), a0)
    want_c = ref.cyclic_polymul(a0, b0, T.P_469762049)
    assert np.array_equal(
        _np(plan.polymul(torch.from_numpy(a0), torch.from_numpy(b0))), want_c)
    # unbatched matrix-form twins: row-major flattening == flat vectors
    fm = plan.fwd_mat(torch.from_numpy(a0.reshape(n1, n2)))
    assert tuple(fm.shape) == (n2, n1)
    assert np.array_equal(_np(fm).ravel(), flat)
    assert np.array_equal(_np(plan.inv_mat(fm)), a0.reshape(n1, n2))
    pm = plan.polymul_mat(torch.from_numpy(a0.reshape(n1, n2)),
                          torch.from_numpy(b0.reshape(n1, n2)))
    assert np.array_equal(_np(pm).ravel(), want_c)
    # batched rows agree with the unbatched callables
    bat = plan.make_batched(B)
    assert np.array_equal(_np(bat["fwd"](torch.from_numpy(a)))[0], flat)


@pytest.mark.parametrize("log_n,rows_log2", [(16, 8), (11, 4)])
def test_natural_ordering(log_n, rows_log2):
    plan = _port_plan(log_n, rows_log2, ordering="natural")
    assert plan.fwd_mat is None and plan.inv_mat is None
    a, b = _inputs(log_n, seed=2)
    want = np.stack([ref.ntt_forward(r, T.P_469762049) for r in a])
    assert np.array_equal(_np(plan.fwd(torch.from_numpy(a[0]))), want[0])
    assert np.array_equal(_np(plan.inv(torch.from_numpy(want[0]))), a[0])
    assert np.array_equal(
        _np(plan.inv(torch.from_numpy(ref.ntt_forward(b[0],
                                                      T.P_469762049)))),
        b[0])
    bat = plan.make_batched(B)
    assert "fwd_mat" not in bat and "inv_mat" not in bat
    got = _np(bat["fwd"](torch.from_numpy(a)))
    assert np.array_equal(got, want)
    assert np.array_equal(_np(bat["inv"](torch.from_numpy(got))), a)
    # polymul is order-agnostic
    assert np.array_equal(
        _np(bat["polymul"](torch.from_numpy(a), torch.from_numpy(b)))[1],
        ref.cyclic_polymul(a[1], b[1], T.P_469762049))


def test_context_delegates():
    jc, tc = _cfgs(16, 8)
    ctx = T.NTTContext(tc, device="cpu")
    plan = _port_plan(16, 8)
    n1, n2 = tc.split
    a, b = (torch.from_numpy(v[0]) for v in _inputs(16, seed=3))
    f = ctx.forward(a)
    assert torch.equal(f, plan.fwd(a))
    assert torch.equal(ctx.inverse(f), a.to(torch.int32))
    assert torch.equal(ctx.polymul(a, b), plan.polymul(a, b))
    fm = ctx.forward_mat(a.reshape(n1, n2))
    assert torch.equal(fm.reshape(-1), f)
    assert torch.equal(ctx.inverse_mat(fm), a.reshape(n1, n2).int())
    assert torch.equal(ctx.polymul_mat(a.reshape(n1, n2), b.reshape(n1, n2)),
                       plan.polymul_mat(a.reshape(n1, n2),
                                        b.reshape(n1, n2)))
    bat = ctx.make_batched(1)
    assert torch.equal(bat["fwd_mat"](a.reshape(n1, n2))[0], fm)
    nat = T.NTTContext(_cfgs(16, 8, ordering="natural")[1], device="cpu")
    with pytest.raises(NotImplementedError):
        nat.forward_mat(a.reshape(n1, n2))
    # a mesh= that is no mesh: the reference's context takes it and fails
    # where it builds its plan; the port's does the same, with the same
    # exception type (a real DeviceMesh: tests/test_torch_dist_api.py)
    from ntt_aie_tpu.api import NTTContext as JContext

    jctx = JContext(jc, mesh=object())
    tctx = T.NTTContext(tc, device="cpu", mesh=object())
    with pytest.raises(Exception) as jerr:
        jctx.plan
    with pytest.raises(type(jerr.value)):
        tctx.plan
    with pytest.raises(TypeError):
        T.NTTContext(tc, device="cpu", overlap_chunks=2)


@pytest.mark.parametrize("ordering", ["bitrev", "natural"])
def test_context_host_paths_match_reference(ordering):
    from ntt_aie_tpu.api import NTTContext as JContext

    jc, tc = _cfgs(16, 8, ordering=ordering)
    a = _inputs(16, seed=4)[0][0]
    want = JContext(jc).forward_host(a)
    ctx = T.NTTContext(tc, device="cpu")
    got = ctx.forward_host(a)
    assert np.array_equal(got, want)
    assert np.array_equal(ctx.inverse_host(got), a)
    if ordering == "bitrev":
        assert np.array_equal(_np(ctx.forward(torch.from_numpy(a))), got)
    # the reference-parity convention: its network, as the reference's
    jref, tref = _cfgs(11, None, table_convention="reference")
    want = JContext(jref).forward_host(a[:2048])
    ref_ctx = T.NTTContext(tref, device="cpu")
    assert np.array_equal(ref_ctx.forward_host(a[:2048]), want)
    assert np.array_equal(_np(ref_ctx.forward(a[:2048])), want)
    with pytest.raises(NotImplementedError, match="no inverse"):
        ref_ctx.inverse_host(want)


@pytest.mark.parametrize("kw,build_kw", [
    ({"log_n": 11, "num_shards": 2}, {}),
])
def test_out_of_slice_configs_raise(kw, build_kw):
    """A configuration sharded over num_shards devices, which raised
    before the distributed plan was ported: build_plan builds the
    single-device plan at its split (8 x 256 here), as the reference's
    build_plan does, and it equals the reference's bit for bit."""
    cfg = T.NTTConfig(field=T.P_469762049, **kw)
    jc = jcfg.NTTConfig(field=jF.P_469762049, **kw)
    assert cfg.split == jc.split == (8, 256)
    plan = T.build_plan(cfg, device="cpu", **build_kw)
    jp = jplan.build_plan(jc, engine="xla")
    a, b = _inputs(cfg.log_n, seed=7)
    a, b = a[0], b[0]
    aj, bj = (jnp.asarray(v, jnp.uint32) for v in (a, b))
    f = _np(plan.fwd(a))
    assert np.array_equal(f, np.asarray(jp.fwd(aj)).astype(np.int64))
    assert np.array_equal(_np(plan.inv(f)), a)
    assert np.array_equal(_np(plan.polymul(a, b)),
                          np.asarray(jp.polymul(aj, bj)).astype(np.int64))


@pytest.mark.parametrize("build_kw", [{"fused": True, "wmat_factored": True},
                                      {"wmat_factored": True}])
def test_factored_configs_build(build_kw):
    """wmat_factored=True, which raised before it was ported: the
    factored column passes, or on a fused plan its fused kernels (recorded
    as the reference records it), with the fold plan's outputs."""
    cfg = T.NTTConfig(field=T.P_469762049, log_n=11, rows_log2=4)
    plan = T.build_plan(cfg, device="cpu", **build_kw)
    assert (plan.wmat_factored, plan.wmat_fold) == (True, False)
    fused = build_kw.get("fused", False)
    assert (set(plan.passes) == {"ff", "fi"}) == fused
    if not fused:
        assert plan.passes["cp2"].wfac_pos == "pre"
        assert plan.passes["icp2"].wfac_pos == "post"
    a = torch.from_numpy(_inputs(11)[0][0])
    fold = T.build_plan(cfg, device="cpu")
    assert torch.equal(plan.fwd(a), fold.fwd(a))
    assert torch.equal(plan.inv(plan.fwd(a)), a.to(torch.int32))


@pytest.mark.parametrize("kw,build_kw", [
    ({"negacyclic": True}, {}),
    ({"negacyclic": True}, {"wmat_fold": False}),
])
def test_formerly_refused_fourstep_configs_build(kw, build_kw):
    """The two four-step configurations that raised before the column
    pass took 'pre' and 'post' operands: the negacyclic product on the
    fold plan, and the wmat_fold=False arm. Both against the NumPy
    oracles (tests/test_torch_nega_fold.py and test_torch_wmat_entry.py
    hold them against the reference's plans)."""
    cfg = T.NTTConfig(field=T.P_469762049, log_n=11, rows_log2=4, **kw)
    plan = T.build_plan(cfg, device="cpu", **build_kw)
    a, b = _inputs(11)
    got = plan.negacyclic_polymul(torch.from_numpy(a[0]),
                                  torch.from_numpy(b[0]))
    assert np.array_equal(got.numpy().astype(np.int64),
                          ref.negacyclic_polymul(a[0], b[0], T.P_469762049))
    fwd = plan.fwd(torch.from_numpy(a[1]))
    natural = np.empty(cfg.n, dtype=np.int64)
    natural[plan.spectral_to_natural] = fwd.numpy()
    assert np.array_equal(natural, ref.ntt_forward(a[1], T.P_469762049))
    assert np.array_equal(plan.inv(fwd).numpy(), a[1])


@pytest.mark.parametrize("fused", [False, True])
def test_flat_default_split_matches_oracle(fused):
    """n = 2^11 on its default (flat) split, which raised before the flat
    arm was ported: bit-reversed output against the NumPy oracle, the
    roundtrip and the cyclic product (tests/test_torch_flat_plan.py holds
    the flat plans against the reference's)."""
    cfg = T.NTTConfig(field=T.P_469762049, log_n=11)
    assert cfg.split == (2048, 1)
    plan = T.build_plan(cfg, device="cpu", fused=fused)
    a, b = _inputs(11)
    got = _np(plan.fwd(torch.from_numpy(a[0])))
    assert np.array_equal(got[plan.spectral_to_natural],
                          ref.ntt_forward(a[0], T.P_469762049))
    assert np.array_equal(_np(plan.inv(torch.from_numpy(got))), a[0])
    assert np.array_equal(_np(plan.polymul(a[0], b[0])),
                          ref.cyclic_polymul(a[0], b[0], T.P_469762049))
