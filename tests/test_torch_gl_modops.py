"""The port's Goldilocks limb arithmetic (int64 carriers of uint32 limbs)
against the reference's uint32 ``gl_*`` and against Python integers, on
random values and the edges of the limb representation. Bit-exact."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu.ops import modops as jM

from ntt_aie_tpu_torch.ops import gl_colpass as G
from ntt_aie_tpu_torch.ops import modops as tM

P = tM.GL_P
# 0, 1, p-1, p-2, 2^32-1, 2^32, and hi = 0xffffffff with lo = 0
EDGES = [0, 1, P - 1, P - 2, (1 << 32) - 1, 1 << 32, 0xFFFFFFFF << 32]


def _operands():
    rng = np.random.default_rng(11)
    r = rng.integers(0, 1 << 64, (2, 3000), dtype=np.uint64) % np.uint64(P)
    e = np.array(EDGES, dtype=np.uint64)
    ea, eb = np.meshgrid(e, e)
    return (np.concatenate([r[0], ea.ravel()]),
            np.concatenate([r[1], eb.ravel()]))


def _limbs(v):
    v = np.asarray(v, dtype=np.uint64)
    return (v >> np.uint64(32)).astype(np.uint32), \
        (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _join(hi, lo):
    hi, lo = (np.asarray(v).astype(np.uint64) for v in (hi, lo))
    return (hi << np.uint64(32)) | lo


def _python(op, a, b):
    f = {"add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P,
         "mul": lambda x, y: x * y % P}[op]
    return np.array([f(int(x), int(y)) for x, y in zip(a, b)],
                    dtype=np.uint64)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_gl_ops_match_reference_and_python(op):
    a, b = _operands()
    args = (*_limbs(a), *_limbs(b))
    got = getattr(tM, f"gl_{op}")(*(_t(v) for v in args))
    want = getattr(jM, f"gl_{op}")(*(jnp.asarray(v) for v in args))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    assert np.array_equal(_join(*(g.numpy() for g in got)),
                          _python(op, a, b))


def test_gl_reduce128_and_canonical_match_reference():
    rng = np.random.default_rng(12)
    limbs = rng.integers(0, 1 << 32, (4, 4000), dtype=np.uint64)
    limbs[:, :8] = [[0] * 8, [0xFFFFFFFF] * 8, [0] * 4 + [0xFFFFFFFF] * 4,
                    [0, 1, 0xFFFFFFFF, 2] * 2]
    r = [v.astype(np.uint32) for v in limbs]
    got = tM._gl_reduce128(*(_t(v) for v in r))
    want = jM._gl_reduce128(*(jnp.asarray(v) for v in r))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    full = [(int(a) << 96) | (int(b) << 64) | (int(c) << 32) | int(d)
            for a, b, c, d in zip(*limbs)]
    assert np.array_equal(_join(*(g.numpy() for g in got)),
                          np.array([v % P for v in full], dtype=np.uint64))
    # gl_canonical takes any 64-bit value (< 2p)
    got = tM.gl_canonical(_t(r[0]), _t(r[1]))
    want = jM.gl_canonical(jnp.asarray(r[0]), jnp.asarray(r[1]))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_limb_helpers_match_reference():
    rng = np.random.default_rng(13)
    x, y, z = (rng.integers(0, 1 << 32, 4000, dtype=np.uint64)
               .astype(np.uint32) for _ in range(3))
    x[:3], y[:3], z[:3] = 0xFFFFFFFF, 0xFFFFFFFF, [0, 1, 0xFFFFFFFF]
    for got, want in ((tM.umul32_wide(_t(x), _t(y)),
                       jM.umul32_wide(jnp.asarray(x), jnp.asarray(y))),
                      (tM._add3_with_carry(_t(x), _t(y), _t(z)),
                       jM._add3_with_carry(jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(z)))):
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_u64_split_and_join():
    a, _ = _operands()
    hi, lo = tM.gl_from_u64(a, "cpu")
    assert hi.dtype == lo.dtype == torch.int32 and hi.shape == a.shape
    assert np.array_equal(hi.numpy().view(np.uint32), _limbs(a)[0])
    assert np.array_equal(lo.numpy().view(np.uint32), _limbs(a)[1])
    back = tM.gl_to_u64(hi, lo)
    assert back.dtype == np.uint64 and np.array_equal(back, a)


def test_pointwise_wrapper_on_cpu_is_the_plain_product():
    a, b = _operands()
    before = G.gl_mul.launches
    got = G.gl_mul(tM.gl_from_u64(a, "cpu"), tM.gl_from_u64(b, "cpu"))
    assert G.gl_mul.launches == before  # the CPU route launches nothing
    assert all(v.dtype == torch.int32 for v in got)
    assert np.array_equal(tM.gl_to_u64(*got), _python("mul", a, b))
    with pytest.raises(ValueError):
        G.gl_mul(tM.gl_from_u64(a, "cpu"), tM.gl_from_u64(b[:10], "cpu"))
    with pytest.raises(TypeError):
        G.gl_mul(tM.gl_from_u64(a, "cpu")[0], tM.gl_from_u64(b, "cpu"))
