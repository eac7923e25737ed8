"""The 32-bit pointwise product (ops/pointwise.py) on the CPU: mul32's
plain route against NumPy's exact (a % p) * (b % p) % p on any uint32
inputs and the edges, with and without broadcast, for every 32-bit prime a
reduction of the port accepts; against the JAX package's
Reduction.mul_data under each kind on canonical inputs; the CUDA kernel's
method (csrc/pointwise.cu: one Barrett reduction of the 64-bit product)
modelled in NumPy against the exact product; its refusals; and the plans
whose products route through it (Plan.pointwise, the n = 2 flat plan, the
distributed plan)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ntt_aie_tpu import fields as jF
from ntt_aie_tpu.ops import reductions as jred

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch.ops import pointwise as PW
from ntt_aie_tpu_torch.parallel import fourstep as FS
from ntt_aie_tpu_torch.parallel import mesh as MS

U32 = (1 << 32) - 1
# every 32-bit field of the port, and the largest modulus montgomery
# accepts (odd p < 2^31: the Mersenne prime 2^31 - 1)
PRIMES = [f.p for f in (T.KYBER, T.DILITHIUM, T.P_469762049, T.P_998244353,
                        T.P_2013265921)] + [(1 << 31) - 1]
# (a's shape, b's shape): the same shape, psi (n,) over a batch, a
# (n1, n2) spectrum over a batch, and a row length off a power of two
SHAPES = [((3, 8, 16), (3, 8, 16)), ((5, 64), (64,)),
          ((3, 8, 16), (8, 16)), ((4, 12), (12,))]
# the (kind, field) pairs whose make_reduction both packages accept
KINDS = [("harvey4", "kyber"), ("harvey4", "dilithium"),
         ("harvey4", "p469762049"), ("harvey", "p469762049"),
         ("harvey", "p998244353"), ("montgomery", "dilithium"),
         ("montgomery", "p469762049"), ("montgomery", "p998244353"),
         ("montgomery", "p2013265921"), ("barrett", "kyber")]


def _edges(p):
    e = np.array([0, 1, p - 1, p, p + 1, 2 * p, 4 * p - 1, (1 << 31) - 1,
                  1 << 31, U32 - 1, U32], dtype=np.uint64)
    return e[e <= U32]


def _values(rng, shape, p):
    """Random uint32 values of `shape`, the first ones the edges."""
    v = rng.integers(0, U32, shape, dtype=np.uint64, endpoint=True)
    flat = v.reshape(-1)
    e = _edges(p)[: flat.size]
    flat[: e.size] = e
    return v


def _t(v):
    return torch.from_numpy(np.ascontiguousarray(v).astype(np.uint32)
                            .view(np.int32))


def _u(t):
    return t.numpy().view(np.uint32).astype(np.uint64)


def _exact(a, b, p):
    pp = np.uint64(p)
    return (a % pp) * (b % pp) % pp


@pytest.mark.parametrize("shape_a,shape_b", SHAPES)
@pytest.mark.parametrize("p", PRIMES)
def test_mul32_matches_numpy(p, shape_a, shape_b):
    rng = np.random.default_rng(p % 1000 + len(shape_a))
    a, b = _values(rng, shape_a, p), _values(rng, shape_b, p)
    # every edge against every edge, in the same-shape case
    if shape_a == shape_b:
        e = _edges(p)
        ea, eb = (v.ravel() for v in np.meshgrid(e, e))
        a, b = (np.concatenate([v.ravel(), w]) for v, w in ((a, ea), (b, eb)))
    got = PW.mul32(_t(a), _t(b), p)
    want = _exact(a, b, p)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(_u(got), want)


@pytest.mark.parametrize("kind,name", KINDS)
def test_mul32_matches_reference_mul_data(kind, name):
    field = T.FIELDS[name]
    p = field.p
    jr = jred.make_reduction(kind, jF.FIELDS[name])
    rng = np.random.default_rng(p % 997)
    a = np.concatenate([[0, 1, p - 1, p - 1], rng.integers(0, p, 4000)])
    b = np.concatenate([[p - 1, 0, 1, p - 1], rng.integers(0, p, 4000)])
    want = np.asarray(jr.mul_data(a.astype(np.uint32), b.astype(np.uint32)))
    got = PW.mul32(_t(a), _t(b), p)
    assert np.array_equal(_u(got), want.astype(np.uint64))


def _umul64hi(t, m):
    """High 64 bits of t * m for uint64 arrays, from 32-bit limbs."""
    m32 = np.uint64(U32)
    s32 = np.uint64(32)
    tl, th = t & m32, t >> s32
    ml, mh = m & m32, m >> s32
    mid1, mid2 = th * ml, tl * mh
    cross = ((tl * ml) >> s32) + (mid1 & m32) + (mid2 & m32)
    return th * mh + (mid1 >> s32) + (mid2 >> s32) + (cross >> s32)


@pytest.mark.parametrize("p", PRIMES)
def test_kernel_method_is_exact(p):
    """csrc/pointwise.cu mulmod: t = a * b, q = umulhi64(t, m) with
    m = floor((2^64 - 1) / p), r = low 32 bits of t - q * p in [0, 2p),
    one conditional subtract."""
    rng = np.random.default_rng(p % 1009)
    e = _edges(p)
    ea, eb = (v.ravel() for v in np.meshgrid(e, e))
    a = np.concatenate([ea, rng.integers(0, U32, 100000, dtype=np.uint64,
                                         endpoint=True)])
    b = np.concatenate([eb, rng.integers(0, U32, 100000, dtype=np.uint64,
                                         endpoint=True)])
    # the products nearest 2^64 and nearest multiples of p
    a = np.concatenate([a, np.full(4, U32, np.uint64),
                        np.array([p - 1, 2 * p - 1], np.uint64)])
    b = np.concatenate([b, np.array([U32, U32 - 1, p, 2], np.uint64),
                        np.array([p - 1, 2 * p - 1], np.uint64)])
    m = np.uint64(U32 * (1 << 32) + U32) // np.uint64(p)
    assert int(m) == ((1 << 64) - 1) // p
    t = a * b  # < 2^64: exact in uint64
    q = _umul64hi(t, np.full_like(t, m))
    r = (t - q * np.uint64(p)) & np.uint64(U32)
    assert int(r.max()) < 2 * p
    r = np.where(r >= p, r - np.uint64(p), r)
    assert np.array_equal(r, _exact(a, b, p))


@pytest.mark.parametrize("case", ["meta", "dtype", "shape", "device",
                                  "p_small", "p_large", "b_larger"])
def test_mul32_refuses(case):
    x = torch.zeros(4, 8, dtype=torch.int32)
    a, b, p = x, x, T.P_469762049.p
    if case == "meta":
        a = b = torch.zeros(4, 8, dtype=torch.int32, device="meta")
    elif case == "dtype":
        b = x.to(torch.int64)
    elif case == "shape":
        b = torch.zeros(4, dtype=torch.int32)
    elif case == "device":
        b = torch.zeros(4, 8, dtype=torch.int32, device="meta")
    elif case == "p_small":
        p = 1
    elif case == "b_larger":  # a broadcast over b is not the contract
        a = x[0]
    else:
        p = 1 << 31
    with pytest.raises(ValueError):
        PW.mul32(a, b, p)


@pytest.fixture
def spy(monkeypatch):
    """Counts mul32's plain-route calls (the CPU side of every product)."""
    calls = []
    plain = PW.mul32_plain

    def counted(a, b, p):
        calls.append((tuple(a.shape), tuple(b.shape), p))
        return plain(a, b, p)

    monkeypatch.setattr(PW, "mul32_plain", counted)
    return calls


@pytest.mark.parametrize("fused", [False, True])
def test_plan_products_route_through_mul32(spy, fused):
    field = T.P_469762049
    cfg = T.NTTConfig(field=field, log_n=8, rows_log2=4)
    plan = T.build_plan(cfg, device="cpu", fused=fused)
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, field.p, (2, 16, 16)) for _ in range(2))
    ta, tb = (torch.from_numpy(v).to(torch.int32) for v in (a, b))
    spectra = plan.make_batched(2)["fwd_mat"](ta)
    got = plan.pointwise(spectra, spectra)
    assert spy == [((2, 16, 16), (2, 16, 16), field.p)]
    assert np.array_equal(_u(got), _exact(_u(spectra), _u(spectra),
                                          field.p))
    del spy[:]
    c = plan.make_batched(2)["polymul_mat"](ta, tb)
    assert len(spy) == 1
    want = ref.cyclic_polymul(a[1].reshape(-1), b[1].reshape(-1), field)
    assert np.array_equal(c[1].reshape(-1).numpy().astype(np.int64), want)


def test_n2_plan_products_route_through_mul32(spy):
    field = T.P_469762049
    plan = T.build_plan(T.NTTConfig(field=field, log_n=1, negacyclic=True),
                        device="cpu")
    a, b = np.array([5, field.p - 1]), np.array([field.p - 2, 7])
    c = plan.polymul(a, b)
    assert len(spy) == 1
    assert np.array_equal(c.numpy().astype(np.int64),
                          ref.cyclic_polymul(a, b, field))
    del spy[:]
    d = plan.negacyclic_polymul(a, b)
    # psi on each operand, the cyclic product, psi^-1
    assert len(spy) == 4 and spy[0][1] == (2,)
    p = field.p
    want = [(a[0] * b[0] - a[1] * b[1]) % p, (a[0] * b[1] + a[1] * b[0]) % p]
    assert d.numpy().astype(np.int64).tolist() == want


@pytest.fixture
def one_rank(tmp_path):
    created = not dist.is_initialized()
    if created:
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
            rank=0, world_size=1)
    yield MS.make_mesh(1, device="cpu")
    if created:
        dist.destroy_process_group()


def test_distributed_products_route_through_mul32(spy, one_rank):
    field = T.P_469762049
    cfg = T.NTTConfig(field=field, log_n=8, rows_log2=4, num_shards=1)
    plan = FS.build_distributed_plan(cfg, one_rank, device="cpu")
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, field.p, 256) for _ in range(2))
    c = plan.gather(plan.polymul(plan.shard_input(a), plan.shard_input(b)))
    assert len(spy) == 1
    assert np.array_equal(c.reshape(-1).numpy().astype(np.int64),
                          ref.cyclic_polymul(a, b, field))
