"""The port's RNSPolymul (CPU: the plain column passes and the plain CRT
combine) against the JAX package's RNSPolymul on its XLA engine and the
exact integer product: cyclic and negacyclic, signed inputs up to
max_input_bound(), one polynomial and a batch, on the flat split
(log_n <= 16, the default there) and on four-step splits (rows_log2
pinned at a small n; and log_n = 17, the default four-step split, held
against the exact product of a sparse input, which the host computes in
O(n) a nonzero). The validation errors are the reference's, message for
message. The port's plans run on one intra-op thread (see
test_torch_red_plans.py).
"""

import functools

import numpy as np
import pytest
import torch

from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import rns as jrns

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch.ops import crt

# (log_n, rows_log2): the flat split, and a four-step one pinned
SPLITS = [(8, None), (10, 5)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _pair(log_n, rows_log2, negacyclic):
    return (T.RNSPolymul(log_n, negacyclic=negacyclic, rows_log2=rows_log2,
                         device="cpu"),
            jrns.RNSPolymul(log_n, negacyclic=negacyclic,
                            rows_log2=rows_log2, engine="xla"))


def _signed_inputs(rns, shape, seed):
    bound = rns.max_input_bound()
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(-bound, bound + 1, shape) for _ in range(2))
    a.flat[0], b.flat[-1] = -bound, bound  # the edges of the bound
    return a, b


def _exact(a, b, negacyclic):
    n = len(a)
    full = np.convolve(a.astype(object), b.astype(object))
    out = full[:n].copy()
    out[:n - 1] += (-1 if negacyclic else 1) * full[n:]
    return out


@pytest.mark.parametrize("negacyclic", [False, True])
@pytest.mark.parametrize("log_n,rows_log2", SPLITS)
def test_rns_matches_reference_and_exact_product(log_n, rows_log2,
                                                 negacyclic):
    rns, jr = _pair(log_n, rows_log2, negacyclic)
    split = rns.plans[0].config.split
    if rows_log2 is None:
        assert split == (1 << log_n, 1)
    else:
        assert split == (1 << rows_log2, 1 << (log_n - rows_log2))
    assert rns.modulus == jr.modulus and rns.nwords == jr.nwords
    assert rns.max_input_bound() == jr.max_input_bound()
    a, b = _signed_inputs(rns, (3, 1 << log_n), log_n)
    got = rns.polymul(a, b)
    assert got.shape == (3, 1 << log_n)
    assert np.array_equal(got, jr.polymul(a, b))
    for r in range(3):
        assert np.array_equal(got[r], _exact(a[r], b[r], negacyclic)), r
    one = rns.polymul(a[1], b[1])
    assert one.shape == (1 << log_n,) and np.array_equal(one, got[1])
    limbs = rns.polymul_limbs(a, b)
    assert limbs.dtype == torch.int32
    assert tuple(limbs.shape) == (3, 1 << log_n, rns.nwords)
    assert np.array_equal(crt.limbs_to_int(limbs), got)


@pytest.mark.parametrize("negacyclic", [False, True])
def test_rns_default_fourstep_split_is_exact(negacyclic):
    """log_n = 17 on its default (four-step, fold) split: a sparse input
    against the exact product, sum_k a_k * X^k * b (mod X^n -/+ 1)."""
    rns = T.RNSPolymul(17, negacyclic=negacyclic, device="cpu")
    assert rns.plans[0].config.split[1] > 1
    key = "negacyclic_polymul_mat" if negacyclic else "polymul_mat"
    assert all(getattr(plan, key) is not None for plan in rns.plans)
    n, bound = rns.n, rns.max_input_bound()
    rng = np.random.default_rng(17)
    idx = np.concatenate([[0, n - 1], rng.choice(np.arange(1, n - 1), 4,
                                                 replace=False)])
    a = np.zeros(n, np.int64)
    a[idx] = rng.integers(-bound, bound + 1, len(idx))
    b = rng.integers(-bound, bound + 1, n)
    want = np.zeros(n, dtype=object)
    for k in idx:
        term = np.roll(b.astype(object), k) * int(a[k])
        if negacyclic:
            term[:k] = -term[:k]
        want += term
    assert np.array_equal(rns.polymul(a, b), want)


def test_rns_validation_matches_reference():
    rns, jr = _pair(8, None, False)
    bound = rns.max_input_bound()
    bad = [np.zeros(128, np.int64), np.zeros((2, 3, 256), np.int64),
           np.full(256, bound + 1), np.full(256, -bound - 1)]
    for a in bad:
        with pytest.raises(ValueError) as terr:
            rns.polymul(a, np.zeros(256, np.int64))
        with pytest.raises(ValueError) as jerr:
            jr.polymul(a, np.zeros(256, np.int64))
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(TypeError) as terr:
        rns.polymul(np.zeros(256), np.zeros(256, np.int64))
    with pytest.raises(TypeError) as jerr:
        jr.polymul(np.zeros(256), np.zeros(256, np.int64))
    assert str(terr.value) == str(jerr.value)
    for tf, jf in (([T.P_469762049, T.GOLDILOCKS],
                    [jF.P_469762049, jF.GOLDILOCKS]),
                   ([T.P_469762049, T.P_469762049],
                    [jF.P_469762049, jF.P_469762049])):
        with pytest.raises(ValueError) as terr:
            T.RNSPolymul(8, tf, device="cpu")
        with pytest.raises(ValueError) as jerr:
            jrns.RNSPolymul(8, jf, engine="xla")
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as terr:
        T.RNSPolymul(8, device="cpu", dp_axis="dp")
    with pytest.raises(ValueError) as jerr:
        jrns.RNSPolymul(8, engine="xla", dp_axis="dp")
    assert str(terr.value) == str(jerr.value)


def test_rns_distributed_and_device_options():
    # the distributed options as the reference takes them: overlap_chunks
    # without a mesh builds the single-device plans (and is not used); a
    # mesh= that is no mesh fails where the plans read its axis, with the
    # reference's exception type (a real DeviceMesh:
    # tests/test_torch_dist_api.py)
    for kw in ({"mesh": object()}, {"overlap_chunks": 2},
               {"mesh": object(), "dp_axis": "dp"}):
        try:
            jrns.RNSPolymul(8, engine="xla", **kw)
            jerr = None
        except Exception as e:  # noqa: BLE001 (its type is the check)
            jerr = e
        if jerr is None:
            assert T.RNSPolymul(8, device="cpu", **kw).plans
        else:
            with pytest.raises(type(jerr)):
                T.RNSPolymul(8, device="cpu", **kw)
    with pytest.raises(TypeError):
        T.RNSPolymul(8, device="cpu", engine="xla")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.RNSPolymul(8)
    rns = T.RNSPolymul(8, rows_log2=4, device="cpu")
    assert all(plan.device.type == "cpu" for plan in rns.plans)
    assert rns.plans[0].config.split == (16, 16)
