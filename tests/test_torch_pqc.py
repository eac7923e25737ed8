"""The port's ML-KEM and ML-DSA rings (``kyber``, ``dilithium``,
``ring_layers``) against the reference's, bit for bit, on the CPU: the
plain route (``ring_layers.layered_fwd``/``layered_inv``, the plain
version of the CUDA kernel ``csrc/ring_layers.cu``) and the torch ops of
basemul, pointwise and matvec, against the reference's jitted pipelines
(XLA; no Pallas kernel is on that path) and the straight scalar
transcriptions of FIPS 203 Algorithms 9-10 and FIPS 204 Algorithms 41-42
(copied from tests/test_kyber.py and tests/test_dilithium.py). Inputs come
from a numpy seed; outputs are canonical, so the comparison is raw."""

import functools

import numpy as np
import pytest
import torch

from ntt_aie_tpu import dilithium as JD
from ntt_aie_tpu import kyber as JK

from ntt_aie_tpu_torch import dilithium as D
from ntt_aie_tpu_torch import kyber as K
from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch import ring_layers as RL
from ntt_aie_tpu_torch.ops import ring_layers as LR

SCHEMES = {"kyber": (K, JK, "basemul"), "dilithium": (D, JD, "pointwise")}
SHAPES = [(256,), (3, 256), (2, 3, 256)]


def _bitrev(x, bits):
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def _kyber_scalar_ntt(f):
    """FIPS 203 Algorithm 9, straight transcription."""
    q, f, k, length = 3329, [int(v) for v in f], 1, 128
    while length >= 2:
        for start in range(0, 256, 2 * length):
            zeta = pow(17, _bitrev(k, 7), q)
            k += 1
            for j in range(start, start + length):
                t = zeta * f[j + length] % q
                f[j + length] = (f[j] - t) % q
                f[j] = (f[j] + t) % q
        length //= 2
    return np.array(f)


def _kyber_scalar_intt(fh):
    """FIPS 203 Algorithm 10, straight transcription."""
    q, f, k, length = 3329, [int(v) for v in fh], 127, 2
    while length <= 128:
        for start in range(0, 256, 2 * length):
            zeta = pow(17, _bitrev(k, 7), q)
            k -= 1
            for j in range(start, start + length):
                t = f[j]
                f[j] = (t + f[j + length]) % q
                f[j + length] = zeta * (f[j + length] - t) % q
        length *= 2
    return np.array([v * 3303 % q for v in f])


def _dilithium_scalar_ntt(f):
    """FIPS 204 Algorithm 41, straight transcription."""
    q, f, k, length = 8380417, [int(v) for v in f], 0, 128
    while length >= 1:
        for start in range(0, 256, 2 * length):
            k += 1
            zeta = pow(1753, _bitrev(k, 8), q)
            for j in range(start, start + length):
                t = zeta * f[j + length] % q
                f[j + length] = (f[j] - t) % q
                f[j] = (f[j] + t) % q
        length //= 2
    return np.array(f)


def _dilithium_scalar_intt(fh):
    """FIPS 204 Algorithm 42, straight transcription."""
    q, f, k, length = 8380417, [int(v) for v in fh], 256, 1
    while length < 256:
        for start in range(0, 256, 2 * length):
            k -= 1
            zeta = -pow(1753, _bitrev(k, 8), q) % q
            for j in range(start, start + length):
                t = f[j]
                f[j] = (t + f[j + length]) % q
                f[j + length] = zeta * (t - f[j + length]) % q
        length *= 2
    return np.array([v * 8347681 % q for v in f])


SCALAR = {"kyber": (_kyber_scalar_ntt, _kyber_scalar_intt),
          "dilithium": (_dilithium_scalar_ntt, _dilithium_scalar_intt)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(scheme, shape, count=2):
    mod = SCHEMES[scheme][0]
    rng = np.random.default_rng([len(shape), shape[0], mod.Q])
    return [rng.integers(0, mod.Q, shape) for _ in range(count)]


@functools.lru_cache(maxsize=None)
def _jax_pipeline(scheme):
    return SCHEMES[scheme][1].make_pipeline()


def _jax(scheme, fn, *args):
    out = _jax_pipeline(scheme)[fn](*(np.asarray(a, np.uint32) for a in args))
    return np.asarray(out).astype(np.int64)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


def _np(x):
    assert x.dtype == torch.int32 and x.device.type == "cpu"
    return x.numpy().astype(np.int64)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_transforms_match_reference(scheme, shape):
    """ntt and intt (each on the reference's spectrum) against the
    reference, the FIPS scalar transcriptions on the first row, and the
    roundtrip."""
    mod, _, _ = SCHEMES[scheme]
    pre = f"{scheme}_"
    a, _ = _inputs(scheme, shape)
    fa = getattr(mod, pre + "ntt")(_t(a))
    want = _jax(scheme, "ntt", a)
    assert fa.shape == shape and np.array_equal(_np(fa), want)
    back = getattr(mod, pre + "intt")(_t(want))
    assert np.array_equal(_np(back), _jax(scheme, "intt", want))
    assert np.array_equal(_np(back), a)
    ntt_s, intt_s = SCALAR[scheme]
    row = a.reshape(-1, 256)[0]
    assert np.array_equal(_np(fa).reshape(-1, 256)[0], ntt_s(row))
    assert np.array_equal(_np(getattr(mod, pre + "intt")(_t(ntt_s(row)))),
                          intt_s(ntt_s(row)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_products_match_reference(scheme, shape):
    """basemul (ML-KEM) or pointwise (ML-DSA) and polymul against the
    reference; polymul's first row against the schoolbook product."""
    mod, _, pw = SCHEMES[scheme]
    q = mod.Q
    a, b = _inputs(scheme, shape)
    got = getattr(mod, f"{scheme}_{pw}")(_t(a), _t(b))
    assert np.array_equal(_np(got), _jax(scheme, "pointwise", a, b))
    c = getattr(mod, f"{scheme}_polymul")(_t(a), _t(b))
    assert np.array_equal(_np(c), _jax(scheme, "polymul", a, b))
    a0, b0 = a.reshape(-1, 256)[0], b.reshape(-1, 256)[0]
    assert np.array_equal(_np(c).reshape(-1, 256)[0],
                          ref.schoolbook_negacyclic(a0, b0, q)
                          .astype(np.int64))


# (A shape, vector shape): one key's matrix against a batch of vectors
# (the serving shape), batched matrices against batched vectors, one
# matrix against one vector (ML-KEM-512's k = l = 2, ML-DSA-44's 4 x 4 at
# l = 2 here)
MATVEC_CASES = [((3, 2, 256), (4, 2, 256)), ((3, 2, 2, 256), (3, 2, 256)),
                ((2, 2, 256), (2, 256))]


@pytest.mark.parametrize("a_shape,s_shape", MATVEC_CASES, ids=str)
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_matvec_matches_reference(scheme, a_shape, s_shape):
    """The NTT-domain module-lattice product with the reference's
    broadcasting, and each batch row equal to the unbatched product."""
    mod, _, _ = SCHEMES[scheme]
    rng = np.random.default_rng([len(a_shape), len(s_shape), mod.Q])
    A = rng.integers(0, mod.Q, a_shape)
    s = rng.integers(0, mod.Q, s_shape)
    mv = getattr(mod, f"{scheme}_matvec")
    got = mv(_t(A), _t(s))
    want = _jax(scheme, "matvec", A, s)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(_np(got), want)
    if len(s_shape) == 3:
        for r in range(s_shape[0]):
            Ar = A[r] if len(a_shape) == 4 else A
            assert np.array_equal(_np(mv(_t(Ar), _t(s[r]))), want[r])


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_matvec_matches_schoolbook(scheme):
    """intt(matvec(ntt(A), ntt(s))) against per-entry schoolbook products
    summed mod q."""
    mod, _, _ = SCHEMES[scheme]
    q, k = mod.Q, 2
    rng = np.random.default_rng([k, q])
    A = rng.integers(0, q, (k, k, 256))
    s = rng.integers(0, q, (k, 256))
    pre = f"{scheme}_"
    t = getattr(mod, pre + "intt")(getattr(mod, pre + "matvec")(
        getattr(mod, pre + "ntt")(_t(A)), getattr(mod, pre + "ntt")(_t(s))))
    for i in range(k):
        want = sum(ref.schoolbook_negacyclic(A[i, j], s[j], q)
                   for j in range(k)) % q
        assert np.array_equal(_np(t)[i], want.astype(np.int64))


# the serving steps of the reference's README: ML-KEM-768 (A 3 x 3) and
# ML-DSA-65 (A 6 x 5), at a batch of 2
SERVING = {"kyber": (3, 3), "dilithium": (6, 5)}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_pipeline_keys_match_reference(scheme):
    """Every make_pipeline key of the port on the CPU against the
    reference's jitted pipeline: the same keys, the same outputs."""
    mod, _, _ = SCHEMES[scheme]
    q, (k, l) = mod.Q, SERVING[scheme]
    pipe = mod.make_pipeline(device="cpu")
    assert sorted(pipe) == sorted(_jax_pipeline(scheme))
    rng = np.random.default_rng([k, l, q])
    A = rng.integers(0, q, (k, l, 256))
    x = rng.integers(0, q, (2, l, 256))
    a, b = rng.integers(0, q, (2, 2, 256))
    for fn, args in (("ntt", (a,)), ("intt", (a,)), ("polymul", (a, b)),
                     ("pointwise", (a, b)), ("matvec", (A, x)),
                     ("serving_step", (A, x))):
        got = pipe[fn](*args)  # NumPy operands go to the pipeline's device
        assert np.array_equal(_np(got), _jax(scheme, fn, *args)), fn
    A_hat = _jax(scheme, "ntt", A)
    step = pipe["make_serving_step"](A_hat)
    jstep = _jax_pipeline(scheme)["make_serving_step"](
        np.asarray(A_hat, np.uint32))
    got = step(_t(x))
    assert tuple(got.shape) == (2, k, 256)
    assert np.array_equal(_np(got), np.asarray(jstep(
        np.asarray(x, np.uint32))).astype(np.int64))


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_kernel_table_layout(scheme):
    """The kernel's flat zeta tables: entry 2^L + b is layer L's block b,
    the standards' index k (zeta^BitRev(k) in the table's form); the
    plain version is a CPU tensor's route and launches nothing."""
    mod = SCHEMES[scheme][0]
    sch = mod.SCHEME
    bits = sch.n_layers
    post = (lambda v: v) if scheme == "kyber" else mod._FIELD.to_mont
    for inverse in (False, True):
        flat = sch.flat_table(inverse)
        assert flat.shape == (1 << bits,) and flat[0] == 0
        for k in range(1, 1 << bits):
            z = pow(mod.ZETA, _bitrev(k, bits), mod.Q)
            if inverse:
                z = pow(z, mod.Q - 2, mod.Q)
            assert flat[k] == post(z)
    LR.layered.launches = 0
    x = torch.zeros((2, 256), dtype=torch.int32)
    assert torch.equal(LR.layered(x, sch), LR.layered_plain(x, sch))
    assert LR.layered.launches == 0
    with pytest.raises(ValueError, match="256"):
        LR.layered(torch.zeros((2, 128), dtype=torch.int32), sch)


def test_layered_plain_is_the_reference_structure():
    """ring_layers.layered_fwd/inv on one row equal the reference's
    (n, B) layout transposed: rows in the port, columns there."""
    from ntt_aie_tpu import ring_layers as JRL
    import jax.numpy as jnp

    q = K.Q
    rng = np.random.default_rng(7)
    x = rng.integers(0, q, (3, 256))
    z = [torch.from_numpy(t.astype(np.int64)) for t in K._ZETAS]
    got = RL.layered_fwd(_t(x), z, K._mul, q)
    from ntt_aie_tpu.ops import modops as JM

    want = JRL.layered_fwd(
        jnp.asarray(x.T, jnp.uint32), JK._ZETAS,
        lambda a, b: JM.barrett_mul(a, b, q, JK._W, JK._U), q)
    assert np.array_equal(got.numpy(), np.asarray(want).T.astype(np.int64))


# ring_product_plain in every mode: (mode, x shape, a shape), with k and l
# of SERVING; "A" stands for the scheme's (k, l, 256) matrix, "bA" for a
# batch of 2 of them, "x" for (2, l, 256) vectors
PRODUCT_CASES = [
    ("product", (3, 256), (3, 256)),
    ("pointwise", (2, 3, 256), (2, 3, 256)),
    ("pointwise", (2, 3, 256), (256,)),  # one operand broadcast
    ("matvec", "x", "A"),
    ("matvec", "x", "bA"),
    ("serve", "x", "A"),
    ("serve_fresh", "x", "A"),
    ("serve_fresh", "x", "bA"),
]


def _product_operands(scheme, x_shape, a_shape):
    mod = SCHEMES[scheme][0]
    k, l = SERVING[scheme]
    named = {"x": (2, l, 256), "A": (k, l, 256), "bA": (2, k, l, 256)}
    x_shape, a_shape = named.get(x_shape, x_shape), named.get(a_shape, a_shape)
    rng = np.random.default_rng([len(x_shape), len(a_shape), mod.Q])
    return (rng.integers(0, mod.Q, x_shape), rng.integers(0, mod.Q, a_shape))


def _product_reference(scheme, mode, x, a):
    """The JAX package's pipeline callable of `mode`."""
    if mode == "product":
        return _jax(scheme, "polymul", x, a)
    if mode == "pointwise":
        return _jax(scheme, "pointwise", x, a)
    if mode == "matvec":
        return _jax(scheme, "matvec", a, x)
    if mode == "serve_fresh":
        return _jax(scheme, "serving_step", a, x)
    step = _jax_pipeline(scheme)["make_serving_step"](np.asarray(a, np.uint32))
    return np.asarray(step(np.asarray(x, np.uint32))).astype(np.int64)


@pytest.mark.parametrize("case", PRODUCT_CASES, ids=str)
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_ring_product_plain_matches_reference(scheme, case):
    """ring_product_plain (the fused kernel's plain version) in every mode,
    with a shared and a batched matrix and a broadcast operand, equal to
    the JAX package bit for bit; ring_product on CPU tensors takes it and
    launches nothing."""
    mode, x_shape, a_shape = case
    sch = SCHEMES[scheme][0].SCHEME
    x, a = _product_operands(scheme, x_shape, a_shape)
    want = _product_reference(scheme, mode, x, a)
    got = LR.ring_product_plain(_t(x).to(torch.int32), _t(a).to(torch.int32),
                                sch, mode)
    assert tuple(got.shape) == want.shape and np.array_equal(_np(got), want)
    LR.layered.launches = 0
    assert torch.equal(LR.ring_product(_t(x), _t(a), sch, mode), got)
    assert LR.layered.launches == 0


@pytest.mark.parametrize("case", PRODUCT_CASES, ids=str)
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_product_operands_batched_form(scheme, case):
    """The kernel route's operands (product_operands: expanded on the host
    to x (B, l, 256) and a shared (k, l, 256) or batched (B, k, l, 256))
    give the broadcasting call's result: ring_product_plain on the batched
    form, reshaped, equals it on the call's operands; a matrix is shared
    exactly where its batch holds one."""
    mode, x_shape, a_shape = case
    sch = SCHEMES[scheme][0].SCHEME
    matrix = LR.MODES[mode][3]
    x, a = (_t(v).to(torch.int32)
            for v in _product_operands(scheme, x_shape, a_shape))
    ops = LR.product_operands(x, a, 256, matrix)
    assert ops.x.shape == (ops.x.shape[0], ops.l, 256)
    assert ops.shared == (matrix and a.dim() == 3)
    if matrix:
        got = LR.ring_product_plain(ops.x, ops.a, sch, mode)
    else:
        got = LR.ring_product_plain(ops.x.reshape(-1, 256),
                                    ops.a.reshape(-1, 256), sch, mode)
    got = got.reshape(ops.out_shape)
    assert torch.equal(got, LR.ring_product_plain(x, a, sch, mode))


def test_ring_product_rejects_unknown_modes_and_shapes():
    """A mode outside MODES and a matvec whose l disagrees raise; the
    kernel's rank limit is the source's."""
    sch = K.SCHEME
    x = torch.zeros((2, 3, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        LR.ring_product(x, x, sch, "convolve")
    with pytest.raises(ValueError, match="matvec"):
        LR.product_operands(x, torch.zeros((3, 2, 256), dtype=torch.int32),
                            256, True)
    assert LR.MAX_RANK == 8
