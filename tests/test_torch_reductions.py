"""The reductions of the port (int64 carriers) against the reference's
uint32 jnp functions: harvey4, harvey, montgomery and barrett, raw bits for
every op and table, the canonical product for mul_data, and barrett_mul and
mont_mul (also against Python integers on the edges). Inputs: random plus
the domain edges."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu import fields as jF
from ntt_aie_tpu.ops import modops as jM
from ntt_aie_tpu.ops import reductions as jred

from ntt_aie_tpu_torch import fields as tF
from ntt_aie_tpu_torch.ops import modops as tM
from ntt_aie_tpu_torch.ops import reductions as tred

P = tF.P_469762049.p
EDGES = np.array([0, 1, P - 1, P, 2 * P - 1, 4 * P - 1, 8 * P - 1],
                 dtype=np.uint64)


def _inputs(seed, n, top):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, top, n, dtype=np.uint64)
    return np.concatenate([EDGES[EDGES < top], x]).astype(np.uint32)


def _pairs(seed, top):
    a = _inputs(seed, 2000, top)
    b = _inputs(seed + 1, 2000, top)
    # every edge against every edge, then random pairs
    ea = np.repeat(a[:7], 7)
    eb = np.tile(b[:7], 7)
    return np.concatenate([ea, a]), np.concatenate([eb, b])


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _j(a):
    return jnp.asarray(np.asarray(a, dtype=np.uint32))


@pytest.fixture(scope="module")
def reds():
    return (jred.make_reduction("harvey4", jF.P_469762049),
            tred.make_reduction("harvey4", tF.P_469762049))


@pytest.mark.parametrize("op", ["add", "sub", "sub_for_mul", "add_for_mul"])
@pytest.mark.parametrize("top", [4 * P, 8 * P])
def test_lazy_add_sub_raw_bits(reds, op, top):
    jr, tr = reds
    a, b = _pairs(7, top)
    want = np.asarray(getattr(jr, op)(_j(a), _j(b))).astype(np.int64)
    got = getattr(tr, op)(_t(a), _t(b)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("top", [4 * P, 8 * P, 1 << 32])
def test_mul_const_raw_bits(reds, top):
    jr, tr = reds
    x = np.concatenate([[(1 << 32) - 1], _inputs(11, 4000, top)])
    x = x.astype(np.uint32)
    w = np.random.default_rng(12).integers(0, P, len(x))
    w[:8] = [0, 1, P - 1, 2, P - 2, 3, 5, P // 2]
    jt = jr.prepare_table(w)
    want = np.asarray(jr.mul_const(_j(x), *map(_j, jt))).astype(np.int64)
    got = tr.mul_const(_t(x), *map(_t, tr.prepare_table(w))).numpy()
    assert np.array_equal(got, want)
    # the packed matrix form
    want = np.asarray(jr.mulc_mat(_j(x), *map(_j, jr.prep_mat(w))))
    got = tr.mulc_mat(_t(x), *map(_t, tr.prep_mat(w))).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    assert got.max() < 4 * P


@pytest.mark.parametrize("top", [4 * P, 8 * P])
def test_canonicalize_raw_bits(reds, top):
    jr, tr = reds
    x = _inputs(13, 4000, top)
    want = np.asarray(jr.canonicalize(_j(x))).astype(np.int64)
    got = tr.canonicalize(_t(x)).numpy()
    assert np.array_equal(got, want)
    if top == 4 * P:
        assert got.max() < P


def test_mul_data_canonical(reds):
    jr, tr = reds
    a, b = _pairs(17, 4 * P)
    want = np.asarray(jr.mul_data(_j(a), _j(b))).astype(np.int64)
    got = tr.mul_data(_t(a), _t(b)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, (a.astype(np.int64) % P)
                          * (b.astype(np.int64) % P) % P)


@pytest.mark.parametrize("name", ["p469762049", "p2013265921"])
def test_mont_mul_and_umulhi(name):
    f = tF.FIELDS[name]
    p, npi = f.p, f.mont_neg_pinv
    rng = np.random.default_rng(19)
    a = np.concatenate([[0, 1, p - 1], rng.integers(0, p, 3000)])
    b = np.concatenate([[p - 1, 0, p - 1], rng.integers(0, p, 3000)])
    want = np.asarray(jM.mont_mul(_j(a), _j(b), p, npi)).astype(np.int64)
    got = tM.mont_mul(_t(a), _t(b), p, npi).numpy()
    assert np.array_equal(got, want)
    x = _inputs(23, 3000, 1 << 32)
    y = _inputs(29, 3000, 1 << 32)
    hi = np.asarray(jM.umulhi32(_j(x), _j(y))).astype(np.int64)
    assert np.array_equal(tM.umulhi32(_t(x), _t(y)).numpy(), hi)
    lo = (x.astype(np.uint64) * y.astype(np.uint64)) & np.uint64(0xFFFFFFFF)
    assert np.array_equal(tM.mullo32(_t(x), _t(y)).numpy(),
                          lo.astype(np.int64))


def test_add_sub_mod_match():
    rng = np.random.default_rng(31)
    a = np.concatenate([[0, P - 1, P - 1], rng.integers(0, P, 2000)])
    b = np.concatenate([[P - 1, 0, P - 1], rng.integers(0, P, 2000)])
    for jf, tf in ((jM.add_mod, tM.add_mod), (jM.sub_mod, tM.sub_mod)):
        want = np.asarray(jf(_j(a), _j(b), P)).astype(np.int64)
        assert np.array_equal(tf(_t(a), _t(b), P).numpy(), want)


def test_carrier_roundtrip():
    x = np.array([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1],
                 dtype=np.int64)
    i32 = tM.from_carrier(torch.from_numpy(x))
    assert i32.dtype == torch.int32
    assert np.array_equal(i32.numpy().view(np.uint32).astype(np.int64), x)
    assert np.array_equal(tM.to_carrier(i32).numpy(), x)


@pytest.mark.parametrize("kind", ["goldilocks"])
def test_unported_reductions_raise(kind):
    # Goldilocks has no Reduction (its plan is goldilocks_plan), and the
    # reference's make_reduction raises the same
    with pytest.raises(ValueError, match="unknown reduction kind"):
        tred.make_reduction(kind, tF.P_469762049)
    with pytest.raises(ValueError, match="unknown reduction kind"):
        jred.make_reduction(kind, jF.P_469762049)


# ---- harvey, montgomery and barrett ----------------------------------------

# (kind, field): each reduction on the fields its plans run, and harvey and
# montgomery forced on p = 469762049
NEW_KINDS = [("harvey", "p998244353"), ("harvey", "p469762049"),
             ("montgomery", "p2013265921"), ("montgomery", "p998244353"),
             ("montgomery", "p469762049"), ("barrett", "kyber")]


def _new_reds(kind, name):
    return (jred.make_reduction(kind, jF.FIELDS[name]),
            tred.make_reduction(kind, tF.FIELDS[name]))


def _domain(kind, p):
    """The top of the reduction's travel domain, and of sub_for_mul's."""
    return {"harvey": (2 * p, 4 * p)}.get(kind, (p, p))


def _edges(top, p):
    e = np.array([0, 1, p - 1, p, 2 * p - 1, 2 * p, 4 * p - 1],
                 dtype=np.uint64)
    return e[e < top]


def _domain_pairs(seed, top, p):
    rng = np.random.default_rng(seed)
    e = _edges(top, p)
    a = np.concatenate([np.repeat(e, len(e)),
                        rng.integers(0, top, 3000, dtype=np.uint64)])
    b = np.concatenate([np.tile(e, len(e)),
                        rng.integers(0, top, 3000, dtype=np.uint64)])
    return a.astype(np.uint32), b.astype(np.uint32)


@pytest.mark.parametrize("kind,name", NEW_KINDS)
@pytest.mark.parametrize("op", ["add", "sub", "sub_for_mul", "add_for_mul",
                                "canonicalize"])
def test_new_reduction_add_sub_raw_bits(kind, name, op):
    jr, tr = _new_reds(kind, name)
    p = tr.p
    top = _domain(kind, p)[0]
    a, b = _domain_pairs(41, top, p)
    jf, tf = getattr(jr, op), getattr(tr, op)
    if jf is None:  # the canonical kinds have no lazy variants
        assert tf is None and kind != "harvey"
        return
    if op == "canonicalize":
        want, got = jf(_j(a)), tf(_t(a))
    else:
        want, got = jf(_j(a), _j(b)), tf(_t(a), _t(b))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    if op in ("add", "sub"):
        assert got.max() < top
    if op == "canonicalize":
        assert got.max() < p


@pytest.mark.parametrize("kind,name", NEW_KINDS)
def test_new_reduction_mul_const_raw_bits(kind, name):
    jr, tr = _new_reds(kind, name)
    p = tr.p
    top = _domain(kind, p)[1]
    rng = np.random.default_rng(43)
    x = np.concatenate([_edges(top, p),
                        rng.integers(0, top, 4000, dtype=np.uint64)])
    if kind == "harvey":  # Shoup takes any x < 2^32
        x = np.concatenate([x, [(1 << 32) - 1, 1 << 31]])
    x = x.astype(np.uint32)
    w = rng.integers(0, p, len(x))
    w[:6] = [0, 1, p - 1, 2, p - 2, p // 2]
    jt, tt = jr.prepare_table(w), tr.prepare_table(w)
    for got, want in zip(tt, jt):
        assert got.dtype == np.uint32 and np.array_equal(got, want)
    want = np.asarray(jr.mul_const(_j(x), *map(_j, jt))).astype(np.int64)
    got = tr.mul_const(_t(x), *map(_t, tt)).numpy()
    assert np.array_equal(got, want)
    # the kernels' one form: (w, w2) pairs and mulc_mat
    pair = tr.pair(w)
    assert len(pair) == 2 and pair[0].shape == w.shape
    assert np.array_equal(tr.mulc_mat(_t(x), *map(_t, pair)).numpy(), want)
    canon = np.asarray(tr.canonicalize(torch.from_numpy(got))).astype(object)
    assert canon.tolist() == [int(a) * int(b) % p
                              for a, b in zip(x, w.astype(object))]


@pytest.mark.parametrize("kind,name", NEW_KINDS)
def test_new_reduction_mul_data_canonical(kind, name):
    jr, tr = _new_reds(kind, name)
    p = tr.p
    a, b = _domain_pairs(47, _domain(kind, p)[0], p)
    if kind != "harvey":  # barrett and REDC take canonical data only
        a, b = a % p, b % p
    want = np.asarray(jr.mul_data(_j(a), _j(b))).astype(np.int64)
    got = tr.mul_data(_t(a), _t(b)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, (a.astype(np.int64) % p)
                          * (b.astype(np.int64) % p) % p)


def test_barrett_mul_matches_reference():
    f = tF.KYBER
    p, w, u = f.p, f.barrett_w, f.barrett_u
    rng = np.random.default_rng(53)
    e = np.array([0, 1, 2, p - 2, p - 1])
    a = np.concatenate([np.repeat(e, 5), rng.integers(0, p, 5000)])
    b = np.concatenate([np.tile(e, 5), rng.integers(0, p, 5000)])
    want = np.asarray(jM.barrett_mul(_j(a), _j(b), p, w, u)).astype(np.int64)
    got = tM.barrett_mul(_t(a), _t(b), p, w, u).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, a * b % p)
    # every canonical pair: the Barrett estimate needs one subtract only
    aa, bb = np.meshgrid(np.arange(p), np.arange(0, p, 7))
    got = tM.barrett_mul(_t(aa.ravel()), _t(bb.ravel()), p, w, u).numpy()
    assert np.array_equal(got, aa.ravel() * bb.ravel() % p)


@pytest.mark.parametrize("name", ["p2013265921", "p998244353"])
def test_mont_mul_edges_exact(name):
    """REDC near 2^31: the plain mont_mul (16-bit limbs) on the edges, held
    against Python integers, which the kernel's __umulhi form computes
    exactly too."""
    f = tF.FIELDS[name]
    p, npi = f.p, f.mont_neg_pinv
    r_inv = pow(1 << 32, -1, p)
    e = [0, 1, 2, p - 2, p - 1, (p - 1) // 2]
    a = np.array([x for x in e for _ in e] + [(1 << 32) - 1] * len(e))
    b = np.array(e * len(e) + e)
    got = tM.mont_mul(_t(a), _t(b), p, npi).numpy()
    assert got.tolist() == [int(x) * int(y) * r_inv % p
                            for x, y in zip(a, b)]
    want = np.asarray(jM.mont_mul(_j(a), _j(b), p, npi)).astype(np.int64)
    assert np.array_equal(got, want)
    # a twiddle of p - 1 in Montgomery form multiplies by -1
    red = tred.make_reduction("montgomery", f)
    x = np.array([0, 1, p - 2, p - 1])
    w = red.pair(np.full(4, p - 1))
    got = red.mulc_mat(_t(x), *map(_t, w)).numpy()
    assert got.tolist() == [(-int(v)) % p for v in x]


@pytest.mark.parametrize("name", ["p2013265921", "p998244353"])
def test_mont_redc_wide_form(name):
    """csrc/reductions.cuh computes REDC as the high word of t + m*p (t =
    x*w, m = lo(t) * neg_pinv; one wide multiply-add on the card). A
    NumPy uint64 model of that form equals the plain mont_mul and the
    reference's raw, for any x < 2^32 and w < p."""
    f = tF.FIELDS[name]
    p, npi = f.p, f.mont_neg_pinv
    rng = np.random.default_rng(23)
    e = [0, 1, 2, p - 2, p - 1, (1 << 31) - 1, (1 << 32) - 1]
    x = np.concatenate([np.repeat(e, 4), rng.integers(0, 1 << 32, 4096)])
    w = np.concatenate([np.tile([0, 1, p - 1, p - 2], len(e)),
                        rng.integers(0, p, 4096)])
    xu, wu = x.astype(np.uint64), w.astype(np.uint64)
    t = xu * wu
    m = ((t & np.uint64(tM.MASK32)) * np.uint64(npi)) & np.uint64(tM.MASK32)
    s = t + m * np.uint64(p)  # < 2p * 2^32 < 2^64: no wrap
    assert not (s & np.uint64(tM.MASK32)).any()
    hi = (s >> np.uint64(32)).astype(np.int64)
    model = np.where(hi >= p, hi - p, hi)
    assert np.array_equal(model, tM.mont_mul(_t(x), _t(w), p, npi).numpy())
    want = np.asarray(jM.mont_mul(_j(x), _j(w), p, npi)).astype(np.int64)
    assert np.array_equal(model, want)


@pytest.mark.parametrize("kind,name", [("harvey", "p2013265921"),
                                       ("barrett", "p998244353"),
                                       ("harvey4", "p998244353")])
def test_reductions_refuse_primes_out_of_range(kind, name):
    with pytest.raises(ValueError):
        tred.make_reduction(kind, tF.FIELDS[name])


def test_reduction_kernel_constants():
    f = tF.P_2013265921
    assert tred.make_reduction("montgomery", f).consts == (f.mont_neg_pinv, 0)
    k = tF.KYBER
    assert tred.make_reduction("barrett", k).consts == (k.barrett_w,
                                                        k.barrett_u)
    for kind in ("harvey", "harvey4"):
        assert tred.make_reduction(kind, tF.P_469762049).consts == (0, 0)
