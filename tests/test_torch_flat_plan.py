"""The port's flat plans (NTTConfig.split = (n, 1), the default for a
single shard up to n = 2^16) against the reference's flat plan, bit for
bit: build_plan(cfg, engine="xla"), the reference's own flat engine (its
``ops/stages.py`` loops with the batch on lanes; no Pallas kernel is on
that path, so nothing compiles in interpret mode).

The port runs the four-step plans at an internal split (here their plain
column passes and fused transforms) and gathers the spectrum into the
flat bit-reversed order; both internal plans are held here: fwd, inv,
polymul and negacyclic_polymul, flat and through make_batched, in the
bitrev and natural orderings (natural changes only fwd and inv).
Outputs are canonical, so the comparison is
raw. Row 0 is also held against the native C++ oracle. The port's plans
run on one intra-op thread (the plain versions are many small ops)."""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu import config as jcfg
from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import plan as jplan

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import native_oracle
from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.plan import flat_inner_split

B = 3
# (field, log_n, ordering): Kyber from 4 to 8 (negacyclic up to 7, its
# largest 2n-th root), ML-DSA's ring, and the three RNS primes under
# harvey4, montgomery and harvey; natural order on Kyber
CASES = ([("kyber", k, "bitrev") for k in (4, 7, 8)]
         + [("dilithium", 8, "bitrev"), ("p469762049", 10, "bitrev"),
            ("p2013265921", 9, "bitrev"), ("p998244353", 9, "bitrev"),
            ("kyber", 8, "natural")])
CALLABLES = ["fwd", "inv", "polymul", "negacyclic_polymul"]
PLANS = ["fold", "fused"]


def _nega(name, log_n) -> bool:
    return 2 << log_n <= T.FIELDS[name].max_n


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(name, log_n):
    rng = np.random.default_rng([log_n, T.FIELDS[name].p])
    p, n = T.FIELDS[name].p, 1 << log_n
    return rng.integers(0, p, (B, n)), rng.integers(0, p, (B, n))


@functools.lru_cache(maxsize=None)
def reference_outputs(name, log_n, ordering):
    """The reference flat plan's batched outputs (its unbatched callables
    equal their rows; compiling both would double this file's time).
    Natural order changes only fwd and inv."""
    jc = jcfg.NTTConfig(field=jF.FIELDS[name], log_n=log_n,
                        ordering=ordering, negacyclic=_nega(name, log_n))
    assert jc.split == (1 << log_n, 1)
    bat = jplan.build_plan(jc, engine="xla").make_batched(B)
    a, b = (jnp.asarray(v, jnp.uint32) for v in _inputs(name, log_n))
    out = {"fwd": bat["fwd"](a)}
    out["inv"] = bat["inv"](out["fwd"])
    if ordering == "bitrev":
        out["polymul"] = bat["polymul"](a, b)
        if jc.negacyclic:
            out["negacyclic_polymul"] = bat["negacyclic_polymul"](a, b)
    return {k: np.asarray(v).astype(np.int64) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def port_plan(name, log_n, ordering, plan):
    cfg = T.NTTConfig(field=T.FIELDS[name], log_n=log_n, ordering=ordering,
                      negacyclic=_nega(name, log_n))
    return T.build_plan(cfg, device="cpu", fused=plan == "fused")


def _np(x):
    return x.numpy().astype(np.int64)


@pytest.mark.parametrize("name,log_n,ordering,fn", [
    case + (fn,) for case in CASES for fn in CALLABLES
    if (case[2] == "bitrev" or fn in ("fwd", "inv"))
    and (fn != "negacyclic_polymul" or _nega(*case[:2]))])
@pytest.mark.parametrize("plan", PLANS)
def test_flat_plan_matches_reference(name, log_n, ordering, plan, fn):
    """The port's flat and batched callables against the reference's
    batched ones (row 0 for the flat callable)."""
    ref = reference_outputs(name, log_n, ordering)
    want = ref[fn]
    pl = port_plan(name, log_n, ordering, plan)
    bat = pl.make_batched(B)
    a, b = _inputs(name, log_n)
    if fn == "inv":
        got_one, got_b = pl.inv(ref["fwd"][0]), bat["inv"](ref["fwd"])
    elif fn == "fwd":
        got_one, got_b = pl.fwd(a[0]), bat["fwd"](a)
    else:
        got_one, got_b = getattr(pl, fn)(a[0], b[0]), bat[fn](a, b)
    assert np.array_equal(_np(got_one), want[0])
    assert np.array_equal(_np(got_b), want)


@pytest.mark.parametrize("name,log_n", [("kyber", 7), ("dilithium", 8),
                                        ("p469762049", 10),
                                        ("p2013265921", 9)])
@pytest.mark.parametrize("plan", PLANS)
def test_flat_plan_row0_matches_native_oracle(name, log_n, plan):
    field = T.FIELDS[name]
    p, n = field.p, 1 << log_n
    pl = port_plan(name, log_n, "bitrev", plan)
    a, b = _inputs(name, log_n)
    omega = field.root_of_unity(n)
    want = native_oracle.ntt_dif_batch(a[:1], omega, p)[0]
    assert np.array_equal(_np(pl.fwd(a[0])), want.astype(np.int64))
    assert np.array_equal(
        _np(pl.polymul(a[0], b[0])),
        native_oracle.cyclic_polymul(a[0], b[0], omega, p).astype(np.int64))
    assert np.array_equal(
        _np(pl.negacyclic_polymul(a[0], b[0])),
        native_oracle.negacyclic_polymul(
            a[0], b[0], field.root_of_unity(2 * n), p).astype(np.int64))
    assert np.array_equal(pl.spectral_to_natural,
                          tw.bit_reverse_indices(n).astype(np.int32))


@pytest.mark.parametrize("plan", PLANS)
def test_flat_plan_shape(plan):
    """The flat plan's surface is the reference's flat one: no matrix-form
    callables, flat and batched; passes at the internal split."""
    pl = port_plan("kyber", 7, "bitrev", plan)
    for k in ("fwd_mat", "inv_mat", "polymul_mat", "negacyclic_polymul_mat"):
        assert getattr(pl, k) is None, k
    assert sorted(pl.make_batched(B)) == sorted(CALLABLES)
    n1, n2 = flat_inner_split(7, fused=plan == "fused")
    net = pl.passes["ff" if plan == "fused" else "cp1"]
    assert (n1, n2) == (16, 8)
    if plan == "fused":
        assert net.shape_in == (n1, n2)
    else:
        assert net.nn == n1
    assert T.NTTConfig(field=T.KYBER, log_n=7).split == (128, 1)


@pytest.mark.parametrize("log_n,kw,split", [
    (2, {}, (2, 2)), (3, {}, (4, 2)), (8, {}, (16, 16)), (9, {}, (32, 16)),
    (16, {}, (1024, 64)), (14, {}, (512, 32)), (10, {}, (8, 128)),
    (16, {"fused": True}, (128, 512)), (14, {"fused": True}, (128, 128)),
    (14, {"goldilocks": True}, (128, 128))])
def test_flat_inner_split(log_n, kw, split):
    """Square, n1 = 2^ceil(log_n / 2), except where another split
    measured faster on the card (plan._FOLD_ROWS_LOG2,
    _FUSED_ROWS_LOG2)."""
    assert flat_inner_split(log_n, **kw) == split


def test_flat_n2_raises():
    """n = 2 has no two-factor split: flat_inner_split raises, and the
    flat plan runs its one butterfly as torch ops instead, with the
    reference's callables: fwd, inv, polymul and negacyclic_polymul, flat
    and batched, equal to the reference's XLA flat plan and the native
    oracle (the reference gives negacyclic_polymul([3, 5], [7, 11]) =
    [469762015, 68])."""
    with pytest.raises(ValueError, match="no two-factor split"):
        flat_inner_split(1)
    field = T.P_469762049
    p = field.p
    pl = T.build_plan(T.NTTConfig(field=field, log_n=1, negacyclic=True),
                      device="cpu")
    assert np.array_equal(_np(pl.negacyclic_polymul([3, 5], [7, 11])),
                          [469762015, 68])
    jbat = jplan.build_plan(jcfg.NTTConfig(field=jF.P_469762049, log_n=1,
                                           negacyclic=True),
                            engine="xla").make_batched(B)
    a, b = _inputs("p469762049", 1)
    ja, jb = (jnp.asarray(v, jnp.uint32) for v in (a, b))
    bat = pl.make_batched(B)
    for fn in CALLABLES:
        args = (a, b) if "polymul" in fn else (a,)
        jargs = (ja, jb) if "polymul" in fn else (ja,)
        want = np.asarray(jbat[fn](*jargs)).astype(np.int64)
        assert np.array_equal(_np(bat[fn](*args)), want), fn
        assert np.array_equal(
            _np(getattr(pl, fn)(*(v[0] for v in args))), want[0]), fn
    assert np.array_equal(_np(pl.inv(pl.fwd(a[0]))), a[0])
    want = native_oracle.ntt_dif_batch(a, field.root_of_unity(2), p)
    assert np.array_equal(_np(bat["fwd"](a)), want.astype(np.int64))
    assert np.array_equal(
        _np(pl.negacyclic_polymul(a[0], b[0])),
        native_oracle.negacyclic_polymul(
            a[0], b[0], field.root_of_unity(4), p).astype(np.int64))
    assert pl.fwd_mat is None and pl.polymul_mat is None


@pytest.mark.parametrize("log_n", [2, 3, 5])
@pytest.mark.parametrize("plan", PLANS)
def test_small_flat_sizes_match_oracle(log_n, plan):
    """The smallest internal splits (2 x 2, 4 x 2, 8 x 4) against the
    native oracle, and the roundtrip."""
    field = T.P_469762049
    n = 1 << log_n
    cfg = T.NTTConfig(field=field, log_n=log_n, negacyclic=True)
    pl = T.build_plan(cfg, device="cpu", fused=plan == "fused")
    a, b = _inputs("p469762049", log_n)
    want = native_oracle.ntt_dif_batch(a, field.root_of_unity(n), field.p)
    got = pl.make_batched(B)["fwd"](a)
    assert np.array_equal(_np(got), want.astype(np.int64))
    assert np.array_equal(_np(pl.make_batched(B)["inv"](got)), a)
    assert np.array_equal(
        _np(pl.negacyclic_polymul(a[0], b[0])),
        native_oracle.negacyclic_polymul(
            a[0], b[0], field.root_of_unity(2 * n), field.p).astype(np.int64))


@pytest.mark.parametrize("ordering", ["bitrev", "natural"])
def test_flat_context(ordering):
    """NTTContext on a flat configuration delegates to the flat plan; its
    host paths agree with it; the matrix-form callables raise, naming
    the flat plan."""
    name, log_n = "dilithium", 8
    cfg = T.NTTConfig(field=T.DILITHIUM, log_n=log_n, ordering=ordering,
                      negacyclic=True)
    ctx = T.NTTContext(cfg, device="cpu")
    pl = port_plan(name, log_n, ordering, "fold")
    a, b = _inputs(name, log_n)
    fa = ctx.forward(a[0])
    assert torch.equal(fa, pl.fwd(a[0]))
    assert np.array_equal(ctx.forward_host(a[0]), _np(fa))
    assert np.array_equal(ctx.inverse_host(_np(fa)), a[0])
    assert np.array_equal(_np(ctx.inverse(fa)), a[0])
    assert torch.equal(ctx.polymul(a[0], b[0]), pl.polymul(a[0], b[0]))
    assert torch.equal(ctx.negacyclic_polymul(a[0], b[0]),
                       pl.negacyclic_polymul(a[0], b[0]))
    with pytest.raises(NotImplementedError, match="flat plan"):
        ctx.polymul_mat(a[0].reshape(16, 16), b[0].reshape(16, 16))
