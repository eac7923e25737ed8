"""The port's Goldilocks host tables equal the reference's, table for
table (np.array_equal, uint64 dtype), so the spectral order of the
Goldilocks plan keeps a single definition."""

import numpy as np
import pytest

from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import twiddles as jtw

from ntt_aie_tpu_torch import fields as tF
from ntt_aie_tpu_torch import twiddles as ttw

JGL, TGL = jF.GOLDILOCKS, tF.GOLDILOCKS


def test_gl_power_series_and_mulmod_match():
    rng = np.random.default_rng(21)
    ws = [1, TGL.root_of_unity(1 << 20), TGL.p - 1,
          int(rng.integers(2, 1 << 63))]
    for w in ws:
        for n in (1, 2, 1000, 4096):
            got = ttw._power_series(TGL, w, n)
            assert got.dtype == np.uint64
            assert np.array_equal(got, jtw._power_series(JGL, w, n))
    a, b = (rng.integers(0, 1 << 64, 5000, dtype=np.uint64)
            % np.uint64(TGL.p) for _ in range(2))
    assert np.array_equal(ttw._gl_mulmod_vec(a, b), jtw._gl_mulmod_vec(a, b))
    for n in (2, 64, 1024):
        assert np.array_equal(ttw.root_powers(TGL, n),
                              jtw.root_powers(JGL, n))


@pytest.mark.parametrize("shape", [(1,), (ttw._GL_BLOCK,),
                                   (ttw._GL_BLOCK + 3,),
                                   (3, ttw._GL_BLOCK // 2 + 5)])
def test_gl_mulmod_blocks_match_the_reference(shape):
    """The blocked product equals the reference's whole-array one across
    block edges, over a 2-D array, and against a scalar operand, values
    up to 2^64 - 1 (not only canonical ones) included."""
    rng = np.random.default_rng(list(shape))
    a = rng.integers(0, 1 << 64, shape, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, shape, dtype=np.uint64)
    a.flat[0], b.flat[-1] = np.uint64((1 << 64) - 1), np.uint64(TGL.p)
    got = ttw._gl_mulmod_vec(a, b)
    assert got.shape == shape and got.dtype == np.uint64
    assert np.array_equal(got, jtw._gl_mulmod_vec(a, b))
    w = int(rng.integers(2, TGL.p, dtype=np.uint64))
    assert np.array_equal(ttw._gl_mulmod_vec(a, w), jtw._gl_mulmod_vec(a, w))
    i = a.size // 2
    assert int(got.flat[i]) == int(a.flat[i]) * int(b.flat[i]) % TGL.p


@pytest.mark.parametrize("nn", [16, 256, 512, 1024])
@pytest.mark.parametrize("direction", ["dif", "dit"])
@pytest.mark.parametrize("inverse", [False, True])
def test_gl_col_network_matches(nn, direction, inverse):
    j = jtw.col_network(JGL, nn, direction=direction, inverse=inverse)
    t = ttw.col_network(TGL, nn, direction=direction, inverse=inverse)
    assert (t["R"], t["S"]) == (j["R"], j["S"])
    assert len(t["phases"]) == len(j["phases"])
    for pt, pj in zip(t["phases"], j["phases"]):
        assert pt["ts"] == pj["ts"]
        assert len(pt["vecs"]) == len(pj["vecs"])
        for vt, vj in zip(pt["vecs"], pj["vecs"]):
            assert vt.dtype == np.uint64
            assert np.array_equal(vt, vj)
    if j["mid"] is None:
        assert t["mid"] is None
    else:
        assert t["mid"]["kind"] == j["mid"]["kind"]
        assert t["mid"]["wmid"].dtype == np.uint64
        assert np.array_equal(t["mid"]["wmid"], j["mid"]["wmid"])


@pytest.mark.parametrize("n1,n2", [(16, 64), (1024, 1024)])
def test_gl_fourstep_tables_match(n1, n2):
    j = jtw.fourstep_tables(JGL, n1, n2)
    t = ttw.fourstep_tables(TGL, n1, n2)
    for k in ("wmat", "iwmat_scaled"):
        assert t[k].dtype == np.uint64, k
        assert np.array_equal(t[k], j[k]), k
    assert np.array_equal(t["pos"], j["pos"])
    assert t["n_inv"] == j["n_inv"]


def test_other_wide_primes_are_refused():
    wide = tF.PrimeField(p=3 * (1 << 30) + 1, g=5)
    with pytest.raises(NotImplementedError, match="Goldilocks"):
        ttw.root_powers(wide, 16)
