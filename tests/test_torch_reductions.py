"""harvey4 arithmetic of the port (int64 carriers) against the reference's
uint32 jnp functions: raw bits for every lazy-domain op, the canonical
product for mul_data and mont_mul. Inputs: random plus the domain edges."""

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


@pytest.mark.parametrize("kind", ["barrett", "montgomery", "harvey",
                                  "goldilocks"])
def test_unported_reductions_raise(kind):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tred.make_reduction(kind, tF.P_469762049)
