"""The four-step plan's wmat_fold=False arm (CPU: the plain column
passes): the four-step multiply at the second pass's entry, as the column
pass's 'pre' operand (cp2: * W, icp1: * W^-1/N), equals the default fold
plan (at the first pass's exit, 'post_t') bit for bit on every callable,
under every 32-bit reduction, with the negacyclic product; and equals the
JAX package's plan on its XLA engine (whose outputs are those of its
Pallas plan either way; its own tests pin that) on the flat callables.
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

import ntt_aie_tpu_torch as T

B = 2
# (field name, log_n, rows_log2): each reduction on the field where 'auto'
# picks it, a nested column (256 rows) in the harvey4 case; Kyber at
# n = 128, its largest negacyclic size
CONFIGS = [("p469762049", 12, 8), ("p998244353", 10, 6),
           ("p2013265921", 10, 4), ("kyber", 7, 3)]
CALLABLES = ["fwd_mat", "inv_mat", "polymul_mat", "negacyclic_polymul_mat",
             "fwd", "inv", "polymul", "negacyclic_polymul"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(name, log_n):
    p = T.FIELDS[name].p
    rng = np.random.default_rng([log_n, p, 7])
    return rng.integers(0, p, (2, B, 1 << log_n))


@functools.lru_cache(maxsize=None)
def _plans(name, log_n, rows_log2):
    cfg = T.NTTConfig(field=T.FIELDS[name], log_n=log_n, rows_log2=rows_log2,
                      negacyclic=True)
    return cfg, {fold: T.build_plan(cfg, device="cpu", wmat_fold=fold)
                 for fold in (True, False)}


@functools.lru_cache(maxsize=None)
def _reference(name, log_n, rows_log2):
    jc = jcfg.NTTConfig(field=jF.FIELDS[name], log_n=log_n,
                        rows_log2=rows_log2, negacyclic=True)
    jb = jplan.build_plan(jc, engine="xla").make_batched(B)
    a, b = (jnp.asarray(v, jnp.uint32) for v in _inputs(name, log_n))
    f = jb["fwd"](a)
    return {"fwd": np.asarray(f), "inv": np.asarray(jb["inv"](f)),
            "polymul": np.asarray(jb["polymul"](a, b)),
            "negacyclic_polymul": np.asarray(jb["negacyclic_polymul"](a, b))}


def _operands(key, cfg, a, b):
    n1, n2 = cfg.split
    if key == "inv_mat":
        return (a.reshape(B, n2, n1),)
    shape = (B, n1, n2) if key.endswith("_mat") else (B, cfg.n)
    ops = (a, b) if "polymul" in key else (a,)
    return tuple(v.reshape(shape) for v in ops)


@pytest.mark.parametrize("key", CALLABLES)
@pytest.mark.parametrize("name,log_n,rows_log2", CONFIGS)
def test_entry_placement_equals_fold(name, log_n, rows_log2, key):
    cfg, plans = _plans(name, log_n, rows_log2)
    a, b = (torch.from_numpy(v) for v in _inputs(name, log_n))
    entry = plans[False]
    # the entry arm carries the four-step matrix on cp2 and icp1 as 'pre'
    assert entry.passes["cp2"].pre is not None
    assert entry.passes["icp1"].pre is not None
    assert entry.passes["cp1"].wmat is None and entry.passes["icp2"].wmat is None
    got = entry.make_batched(B)[key](*_operands(key, cfg, a, b))
    want = plans[True].make_batched(B)[key](*_operands(key, cfg, a, b))
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,log_n,rows_log2", CONFIGS)
def test_entry_placement_matches_reference(name, log_n, rows_log2):
    cfg, plans = _plans(name, log_n, rows_log2)
    want = _reference(name, log_n, rows_log2)
    a, b = (torch.from_numpy(v) for v in _inputs(name, log_n))
    bat = plans[False].make_batched(B)
    f = bat["fwd"](a)
    got = {"fwd": f, "inv": bat["inv"](f), "polymul": bat["polymul"](a, b),
           "negacyclic_polymul": bat["negacyclic_polymul"](a, b)}
    for key, value in got.items():
        assert np.array_equal(value.numpy().astype(np.int64) & 0xFFFFFFFF,
                              want[key]), key
    one = plans[False]
    assert np.array_equal(one.fwd(a[0]).numpy(), want["fwd"][0])


def test_entry_placement_options():
    """wmat_fold=False does not apply to the fused plan or a flat split, as
    in the reference; wmat_factored=True overrides it, and Goldilocks has
    the arm too (both raised before they were ported)."""
    cfg = T.NTTConfig(field=T.P_469762049, log_n=10, rows_log2=5)
    fused = T.build_plan(cfg, device="cpu", fused=True, wmat_fold=False)
    assert set(fused.passes) == {"ff", "fi"}
    flat = T.build_plan(T.NTTConfig(field=T.P_469762049, log_n=8),
                        device="cpu", wmat_fold=False)
    assert flat.passes["cp1"].wmat is not None  # the fold at the inner split
    ctx = T.NTTContext(cfg, device="cpu", wmat_fold=False)
    a = np.arange(cfg.n)
    assert np.array_equal(ctx.inverse(ctx.forward(a)).numpy(), a)
    fac = T.build_plan(cfg, device="cpu", wmat_factored=True,
                       wmat_fold=False)
    assert (fac.wmat_factored, fac.wmat_fold) == (True, False)
    assert fac.passes["cp2"].pre is None and fac.passes["cp2"].wfac
    gl = T.build_plan(T.NTTConfig(field=T.GOLDILOCKS, log_n=12, rows_log2=6),
                      device="cpu", wmat_fold=False)
    assert (gl.wmat_factored, gl.wmat_fold) == (False, False)
    assert gl.passes["cp2"].pre is not None
