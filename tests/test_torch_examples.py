"""The port's worked examples (``ntt_aie_tpu_torch.examples``) on the CPU
against the JAX package's same calls on the same inputs, bit for bit:
each example's ``run(..., device="cpu")`` returns its seeded inputs
(``np.random.default_rng(0)``, as the reference examples draw them) and
the outputs it checked, and the reference computes them again on its XLA
engine (never interpret-mode Pallas). Bigint compares Python integers, as
does the distributed example's RNS product, against the exact one. The
matrix-form example's serving loop is pinned by counting the batched
callables it calls: per request one fwd_mat and one inv_mat against the
cached spectra, never polymul_mat.

Time: the examples' CPU runs are cheap and run first, in the module's
fixture; the reference's compiles (most of the file's time) then run in
threads beside the distributed example's four spawned gloo ranks (the
hierarchical branch included), and the tests read their results. The
rlwe, matform and distributed cases run at one n, 2^9, and share the
reference's contexts, so each of its jitted shapes compiles once; the
bigint products, 256 and 4,096 bits, go through one reference
RNSPolymul (n = 2^9, the 256-bit operands zero-padded: the same integer
product)."""

import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntt_aie_tpu import dilithium as JD
from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import kyber as JK
from ntt_aie_tpu import reference as jref
from ntt_aie_tpu import rns as jrns
from ntt_aie_tpu.api import NTTContext as JContext
from ntt_aie_tpu.config import NTTConfig as JConfig

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch.examples import (bigint_multiply, distributed_demo,
                                        pqc_serving_demo, rlwe_demo,
                                        serving_matform_demo)
from ntt_aie_tpu_torch.plan import Plan

JFIELD = jF.P_469762049
LOG_N = 9  # rlwe, matform, the distributed example and its small context
BATCH = 4  # matform and pqc
BITS = (256, 4096)


def _host(v):
    """A tensor or array of values < 2^31 as int64 host values."""
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.asarray(v).astype(np.int64)


def _u32(v):
    return jnp.asarray(np.asarray(v).astype(np.uint32))


def _jcontext(rows_log2=None):
    """The reference's negacyclic context at n = 2^LOG_N (its fwd and
    polymul are the cyclic ones) on its XLA engine: flat by default."""
    kw = {} if rows_log2 is None else {"rows_log2": rows_log2}
    return JContext(JConfig(field=JFIELD, log_n=LOG_N, negacyclic=True,
                            **kw), engine="xla")


def _plans_want(rlwe, matform):
    """The reference's rlwe product (the flat context) and matform's
    flat batched fwd and polymul (the four-step context: its XLA engine
    has no matrix-form callables, so the example's are held flattened,
    row-major, the flat contract); the contexts, for the distributed
    cases."""
    flat, four = _jcontext(), _jcontext(LOG_N // 2)
    bat = four.make_batched(BATCH)
    spec = bat["fwd"](_u32(matform["kern"]))
    prod = bat["polymul"](_u32(matform["msgs"]), _u32(matform["kern"]))
    return {"rlwe": flat.plan.negacyclic_polymul(_u32(rlwe["a"]),
                                                 _u32(rlwe["s"])),
            # the unbatched twin's product is row 0's
            "matform": {"k_spec": spec, "fwd": spec, "out": prod,
                        "polymul_mat": prod, "one": prod[0]},
            "flat": flat, "batched": bat}


def _rns_want(bigints):
    """The reference RNSPolymul's product of each run's digits, padded to
    n = 2^LOG_N."""
    rns, size = jrns.RNSPolymul(LOG_N), 1 << LOG_N
    return {bits: rns.polymul(*(np.pad(out[k], (0, size - out[k].size))
                                for k in ("x_digits", "y_digits")))
            for bits, out in bigints.items()}


def _pqc_want(out):
    ky, dl = JK.make_pipeline(), JD.make_pipeline()
    A, s = out["A"], out["s"]
    # the fixed-A step is the fresh-A step with A[0] in every lane: the
    # same jitted shape
    return {"t": ky["serving_step"](A, s),
            "w": dl["serving_step"](out["A2"], out["y"]),
            "t_fixed": ky["serving_step"](np.broadcast_to(A[:1], A.shape),
                                          s)}


@pytest.fixture(scope="module")
def ex():
    """The examples' CPU runs and futures of the reference's outputs for
    them and of the distributed example. Only the reference and the
    spawned ranks run in the threads: the port's plans are untouched
    while the tests below count their calls."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {"rlwe": rlwe_demo.run(LOG_N, device="cpu"),
           "matform": serving_matform_demo.run(LOG_N, BATCH, device="cpu"),
           "pqc": pqc_serving_demo.run(BATCH, device="cpu"),
           "bigint": {b: bigint_multiply.run(b, device="cpu") for b in BITS}}
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futures = {
            "dist": pool.submit(distributed_demo.run, LOG_N, world=4,
                                backend="gloo", device="cpu"),
            "plans": pool.submit(_plans_want, out["rlwe"], out["matform"]),
            "rns": pool.submit(_rns_want, out["bigint"]),
            "pqc": pool.submit(_pqc_want, out["pqc"])}
        yield out, futures
        for f in futures.values():
            f.result()
    torch.set_num_threads(threads)


def test_rlwe_matches_reference(ex):
    out, want = ex
    assert np.array_equal(_host(out["rlwe"]["prod"]),
                          _host(want["plans"].result()["rlwe"]))


@pytest.mark.parametrize("bits", BITS)
def test_bigint_matches_reference(ex, bits):
    out, want = ex[0]["bigint"][bits], ex[1]["rns"].result()[bits]
    n = 1 << out["log_n"]
    assert [int(v) for v in out["coeffs"]] == [int(v) for v in want[:n]]
    assert not any(want[n:])
    assert bigint_multiply.coeffs_to_int(want) == out["product"] \
        == out["x"] * out["y"]


def test_bigint_digits_round_trip():
    x = (1 << 4095) + 12345
    digits = bigint_multiply.int_to_coeffs(x, 512)
    assert digits.shape == (512,) and digits.max() < (1 << 16)
    assert bigint_multiply.coeffs_to_int(digits) == x
    assert bigint_multiply.coeffs_to_int(digits[:3]) == x % (1 << 48)


@pytest.mark.parametrize("key", ["k_spec", "out", "polymul_mat", "fwd",
                                 "one"])
def test_matform_matches_reference(ex, key):
    out, want = ex[0]["matform"], ex[1]["plans"].result()["matform"]
    assert np.array_equal(_host(out[key]).reshape(-1),
                          _host(want[key]).reshape(-1))


def _counting(calls):
    """Plan.make_batched whose callables append their names to calls."""
    make = Plan.make_batched

    def wrapped(self, batch):
        def count(name, fn):
            def call(*args):
                calls.append(name)
                return fn(*args)

            return call

        return {k: count(k, fn) for k, fn in make(self, batch).items()}

    return wrapped


def test_matform_loop_uses_the_cached_spectra(monkeypatch):
    """The request runs fwd_mat then inv_mat, between the cache's fwd_mat
    and the checks; polymul_mat runs once, after the loop, as its check."""
    calls = []
    monkeypatch.setattr(Plan, "make_batched", _counting(calls))
    serving_matform_demo.run(LOG_N, BATCH, device="cpu")
    assert calls == ["fwd_mat", "fwd_mat", "inv_mat", "polymul_mat", "fwd"]


def test_matform_serve_per_request(monkeypatch):
    """Several requests against one cache: each exactly one fwd_mat and
    one inv_mat and no polymul_mat, and each equal to polymul_mat."""
    calls = []
    monkeypatch.setattr(Plan, "make_batched", _counting(calls))
    plan = T.build_plan(T.NTTConfig(field=T.P_469762049, log_n=LOG_N,
                                    rows_log2=LOG_N // 2), device="cpu")
    bat = plan.make_batched(BATCH)
    rng = np.random.default_rng(0)
    shape = (BATCH,) + plan.config.split

    def draw():
        return torch.from_numpy(rng.integers(0, T.P_469762049.p,
                                             shape)).to(torch.int32)

    kern = draw()
    k_spec = bat["fwd_mat"](kern)
    for r in range(3):
        msgs = draw()
        calls.clear()
        got = serving_matform_demo.serve(bat, plan.pointwise, k_spec, msgs)
        assert calls == ["fwd_mat", "inv_mat"], r
        assert torch.equal(got, plan.make_batched(BATCH)["polymul_mat"](
            msgs, kern)), r


# (field, log_n, rows_log2): the 32-bit and Goldilocks four-step plans,
# and both kinds' n = 2 plans (flat, their stage loops)
POINTWISE_PLANS = [("P_469762049", 8, 4), ("GOLDILOCKS", 8, 4),
                   ("P_469762049", 1, None), ("GOLDILOCKS", 1, None)]


@pytest.mark.parametrize("field,log_n,rows_log2", POINTWISE_PLANS)
def test_plan_pointwise_is_polymuls_product(field, log_n, rows_log2):
    """Plan.pointwise is the product polymul runs between its transforms:
    inv(pointwise(fwd(a), fwd(b))) is polymul(a, b) bit for bit, and
    likewise through the matrix-form callables where the plan has them
    (a Goldilocks plan's values are (hi, lo) pairs)."""
    from ntt_aie_tpu_torch.ops import modops as M

    f = getattr(T, field)
    kw = {} if rows_log2 is None else {"rows_log2": rows_log2}
    plan = T.build_plan(T.NTTConfig(field=f, log_n=log_n, **kw),
                        device="cpu")
    rng = np.random.default_rng([log_n, f.p % 1000])
    gl = field == "GOLDILOCKS"

    def draw(shape):
        if gl:
            v = rng.integers(0, 1 << 64, shape, dtype=np.uint64)
            return M.gl_from_u64(v % np.uint64(f.p), "cpu")
        return torch.from_numpy(rng.integers(0, f.p, shape)).to(torch.int32)

    def equal(x, y):
        return all(map(torch.equal, x, y)) if gl else torch.equal(x, y)

    n = 1 << log_n
    a, b = draw((n,)), draw((n,))
    assert equal(plan.inv(plan.pointwise(plan.fwd(a), plan.fwd(b))),
                 plan.polymul(a, b))
    if plan.fwd_mat is None:
        assert log_n == 1
        return
    a, b = draw(plan.config.split), draw(plan.config.split)
    assert equal(plan.inv_mat(plan.pointwise(plan.fwd_mat(a),
                                             plan.fwd_mat(b))),
                 plan.polymul_mat(a, b))


@pytest.mark.parametrize("key", ["t", "w", "t_fixed"])
def test_pqc_matches_reference(ex, key):
    out, want = ex[0]["pqc"], ex[1]["pqc"].result()
    assert np.array_equal(_host(out[key]), _host(want[key]))


@pytest.mark.parametrize("p", [3329, 8380417, JFIELD.p, jF.GOLDILOCKS.p])
def test_schoolbook_oracle_matches_reference(p):
    """The examples' oracle, the port's schoolbook product, equals the
    reference's scalar loop (n = 1, 2 and 64)."""
    rng = np.random.default_rng(p % 1000)
    for n in (1, 2, 64):
        a, b = ([int(v) for v in rng.integers(0, min(p, 1 << 62), n)]
                for _ in range(2))
        got = ref.schoolbook_negacyclic(a, b, p)
        assert got.dtype == object
        assert list(got) == list(jref.schoolbook_negacyclic(a, b, p))


def test_distributed_spectrum_matches_reference(ex):
    """The gathered spectrum is the single-device plan's at its split:
    row 0 of the reference's batched fwd (matform's shape) with the
    input in every row."""
    dist, plans = ex[1]["dist"].result(), ex[1]["plans"].result()
    rows = np.broadcast_to(dist["a"], (BATCH, dist["a"].size))
    want = _host(plans["batched"]["fwd"](_u32(rows)))[0]
    assert np.array_equal(dist["spec"].reshape(-1), want)
    assert np.array_equal(dist["hier_spec"].reshape(-1), want)
    assert np.array_equal(dist["back"], dist["a"])
    assert dist["world"] == 4 and dist["backend"] == "gloo"
    assert len(dist["lines"]) == 4  # the hierarchical branch ran


def test_distributed_negacyclic_matches_reference(ex):
    """The mesh's product and the small context's, both in natural
    coefficient order, against the reference's flat context."""
    dist, plans = ex[1]["dist"].result(), ex[1]["plans"].result()
    nega = plans["flat"].plan.negacyclic_polymul
    want = nega(_u32(dist["a"]), _u32(dist["b"]))
    assert np.array_equal(_host(dist["negacyclic"]), _host(want))
    sa, sb, sgot = dist["small"]
    assert np.array_equal(_host(sgot), _host(nega(_u32(sa), _u32(sb))))


def test_distributed_rns_is_the_exact_product(ex):
    """The mesh's RNS product (held in the ranks against the single-device
    RNSPolymul) against the exact cyclic product of the integers, which
    is what the reference's RNSPolymul(10) returns for inputs within its
    bound (its compile would cost the file ~5 s; the bigint cases above
    hold RNSPolymul against it)."""
    dist = ex[1]["dist"].result()
    a, b = dist["big_a"], dist["big_b"]
    want = np.zeros(len(a), dtype=object)
    for i, ai in enumerate(a):
        want += ai * np.roll(b, i)
    assert [int(v) for v in dist["rns"]] == [int(v) for v in want]
