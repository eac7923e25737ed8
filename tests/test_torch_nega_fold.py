"""The negacyclic product on the four-step fold plan (CPU: the plain
column passes), bit for bit: ``negacyclic_polymul`` and
``negacyclic_polymul_mat``, unbatched and through ``make_batched``, under
every 32-bit reduction on the field where 'auto' picks it (Kyber's
barrett at n = 128, its largest negacyclic size, on a pinned split), and
with ordering='natural'. Held against the JAX package's plan on its XLA
engine (``build_plan(..., engine="xla")``: psi scalings around its cyclic
product; it compiles in seconds where its Pallas plan in interpret mode
takes tens) and its NumPy oracle ``reference.negacyclic_polymul``; the
port's plan runs ncp1 (psi as 'pre') and nicp1 (psi^-1 as 'post').
The port's plans run on one intra-op thread (see test_torch_red_plans.py).
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu import config as jcfg
from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import plan as jplan
from ntt_aie_tpu import reference as jref

import ntt_aie_tpu_torch as T

B = 2
# (field name, log_n, rows_log2, reduction 'auto' resolves to)
CONFIGS = [("p469762049", 11, 4, "harvey4"), ("p998244353", 10, 6, "harvey"),
           ("p2013265921", 10, 4, "montgomery"), ("kyber", 7, 3, "barrett")]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(name, log_n):
    p = T.FIELDS[name].p
    rng = np.random.default_rng([log_n, p])
    n = 1 << log_n
    return rng.integers(0, p, (B, n)), rng.integers(0, p, (B, n))


@functools.lru_cache(maxsize=None)
def _reference(name, log_n, rows_log2):
    """The reference XLA plan's negacyclic product of _inputs, batched and
    of row 0 alone."""
    jc = jcfg.NTTConfig(field=jF.FIELDS[name], log_n=log_n,
                        rows_log2=rows_log2, negacyclic=True)
    jp = jplan.build_plan(jc, engine="xla")
    a, b = (jnp.asarray(v, jnp.uint32) for v in _inputs(name, log_n))
    batched = np.asarray(jp.make_batched(B)["negacyclic_polymul"](a, b))
    one = np.asarray(jp.negacyclic_polymul(a[0], b[0]))
    return batched, one


def _port(name, log_n, rows_log2, **kw):
    cfg = T.NTTConfig(field=T.FIELDS[name], log_n=log_n, rows_log2=rows_log2,
                      negacyclic=True, **kw)
    return cfg, T.build_plan(cfg, device="cpu")


def _np(t):
    return t.numpy().astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("name,log_n,rows_log2,kind", CONFIGS)
def test_fold_negacyclic_matches_reference(name, log_n, rows_log2, kind):
    cfg, plan = _port(name, log_n, rows_log2)
    assert plan.reduction == kind
    assert {"ncp1", "nicp1"} <= set(plan.passes)
    assert "nf" not in plan.passes
    n1, n2 = cfg.split
    a, b = _inputs(name, log_n)
    want_b, want_1 = _reference(name, log_n, rows_log2)
    got = plan.negacyclic_polymul(torch.from_numpy(a[0]),
                                  torch.from_numpy(b[0]))
    assert np.array_equal(_np(got), want_1)
    oracle = jref.negacyclic_polymul(a[0], b[0], jF.FIELDS[name])
    assert np.array_equal(_np(got), np.asarray(oracle, dtype=np.int64))
    mat = plan.negacyclic_polymul_mat(torch.from_numpy(a[0].reshape(n1, n2)),
                                      torch.from_numpy(b[0].reshape(n1, n2)))
    assert tuple(mat.shape) == (n1, n2)
    assert np.array_equal(_np(mat).reshape(-1), want_1)
    bat = plan.make_batched(B)
    got_b = bat["negacyclic_polymul"](torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(_np(got_b), want_b)
    mat_b = bat["negacyclic_polymul_mat"](
        torch.from_numpy(a.reshape(B, n1, n2)),
        torch.from_numpy(b.reshape(B, n1, n2)))
    assert np.array_equal(_np(mat_b).reshape(B, -1), want_b)


@pytest.mark.parametrize("name,log_n,rows_log2,kind", CONFIGS[::3])
def test_fold_negacyclic_natural_ordering(name, log_n, rows_log2, kind):
    """ordering='natural' changes the transforms' order only: the product
    is the same, and the matrix-form product stays."""
    cfg, plan = _port(name, log_n, rows_log2, ordering="natural")
    n1, n2 = cfg.split
    a, b = _inputs(name, log_n)
    want_b, _ = _reference(name, log_n, rows_log2)
    assert plan.fwd_mat is None
    bat = plan.make_batched(B)
    got = bat["negacyclic_polymul"](torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(_np(got), want_b)
    mat = plan.negacyclic_polymul_mat(torch.from_numpy(a[1].reshape(n1, n2)),
                                      torch.from_numpy(b[1].reshape(n1, n2)))
    assert np.array_equal(_np(mat).reshape(-1), want_b[1])
