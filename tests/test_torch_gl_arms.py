"""The Goldilocks plan's wmat_fold=False and wmat_factored=True arms (CPU:
the plain column passes), and the broadcast Goldilocks product.

The Goldilocks column pass's factored 'wfac' operand (on cp2's load, as
the factored arm runs it) and its rank-1 operand (the reference's, which
only its distributed plan runs; the plain version has it) against the
reference Pallas kernel in interpret mode, raw on both limb planes (every
Goldilocks value is canonical). Then both arms against the port's fold
plan, bit for bit on every callable with the negacyclic product, at
n = 2^12 on the 64 x 64 split, and their flat callables against the JAX
package's Goldilocks plan on its XLA engine. Last, gl_mul with its second
operand broadcast over the batch (psi, as the negacyclic product holds it
once) against the product of operands of one shape.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu import config as jcfg
from ntt_aie_tpu import fields as jF
from ntt_aie_tpu.goldilocks_plan import build_goldilocks_plan as j_build
from ntt_aie_tpu.ops import pallas_gl as PG

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.goldilocks_plan import gl_fold_passes
from ntt_aie_tpu_torch.ops import gl_colpass as G
from ntt_aie_tpu_torch.ops import modops as M

P = T.GOLDILOCKS.p
B = 2
NN, NCOLS = 32, 16
LOG_N, ROWS_LOG2 = 12, 6
ARMS = {"entry": {"wmat_fold": False}, "factored": {"wmat_factored": True}}
CALLABLES = ["fwd_mat", "inv_mat", "polymul_mat", "negacyclic_polymul_mat",
             "fwd", "inv", "polymul", "negacyclic_polymul"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _values(rng, shape):
    return rng.integers(0, 1 << 64, shape, dtype=np.uint64) % np.uint64(P)


@pytest.mark.parametrize("operand", ["wfac", "rank1"])
def test_gl_factored_plain_matches_pallas(operand):
    if operand == "wfac":
        tabs = tw.fourstep_wfac_T(T.GOLDILOCKS, NCOLS, NN)
    else:
        tabs = tw.negacyclic_psi_factors(T.GOLDILOCKS, NN, NCOLS)
    jcp = PG.make_gl_colpass(jF.GOLDILOCKS, NN, NCOLS, direction="dif",
                             batch=B, interpret=True,
                             **{operand: tabs, f"{operand}_pos": "pre"})
    x = _values(np.random.default_rng(len(operand)), (B, NN, NCOLS))
    hi, lo = M.gl_from_u64(x, "cpu")
    wh, wl = jcp(jnp.asarray(hi.numpy().view(np.uint32)),
                 jnp.asarray(lo.numpy().view(np.uint32)))
    cp = G.make_gl_colpass(T.GOLDILOCKS, NN, direction="dif", device="cpu",
                           **{operand: tabs, f"{operand}_pos": "pre"})
    assert G.variant(cp) == f"dif+{operand}_pre"
    got = G.gl_colpass((hi, lo), cp)
    assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(wh))
    assert np.array_equal(got[1].numpy().view(np.uint32), np.asarray(wl))


def _inputs(seed=0):
    return _values(np.random.default_rng([LOG_N, seed]), (2, B, 1 << LOG_N))


@functools.lru_cache(maxsize=None)
def _plans():
    cfg = T.NTTConfig(field=T.GOLDILOCKS, log_n=LOG_N, rows_log2=ROWS_LOG2,
                      negacyclic=True)
    plans = {arm: T.build_plan(cfg, device="cpu", **kw)
             for arm, kw in ARMS.items()}
    plans["fold"] = T.build_plan(cfg, device="cpu")
    return cfg, plans


def _operands(key, cfg, a, b):
    n1, n2 = cfg.split
    if key == "inv_mat":
        return (a.reshape(B, n2, n1),)
    shape = (B, n1, n2) if key.endswith("_mat") else (B, cfg.n)
    ops = (a, b) if "polymul" in key else (a,)
    return tuple(v.reshape(shape) for v in ops)


@pytest.mark.parametrize("key", CALLABLES)
@pytest.mark.parametrize("arm", list(ARMS))
def test_gl_arm_equals_fold(arm, key):
    cfg, plans = _plans()
    plan = plans[arm]
    assert (plan.wmat_fold, plan.wmat_factored) == (False, arm == "factored")
    assert (plans["fold"].wmat_fold, plans["fold"].wmat_factored) == (True,
                                                                      False)
    want_variants = ({"cp1": "dif+T", "cp2": "dif+pre", "icp2": "dit+T",
                      "icp1": "dit+pre"} if arm == "entry" else
                     {"cp1": "dif+T", "cp2": "dif+wfac_pre",
                      "icp2": "dit+wfac_post+T", "icp1": "dit"})
    assert {k: G.variant(cp) for k, cp in plan.passes.items()} == \
        want_variants
    a, b = _inputs()
    got = plan.make_batched(B)[key](*_operands(key, cfg, a, b))
    want = plans["fold"].make_batched(B)[key](*_operands(key, cfg, a, b))
    assert got.dtype == np.uint64
    assert np.array_equal(got, want)


@functools.lru_cache(maxsize=None)
def _reference():
    jc = jcfg.NTTConfig(field=jF.GOLDILOCKS, log_n=LOG_N,
                        rows_log2=ROWS_LOG2, negacyclic=True)
    jb = j_build(jc, engine="xla").make_batched(B)
    a, b = _inputs()
    f = jb["fwd"](a)
    out = {"fwd": f, "inv": jb["inv"](f), "polymul": jb["polymul"](a, b),
           "negacyclic_polymul": j_build(jc, engine="xla")
           .negacyclic_polymul(a[0], b[0])}
    return {k: np.asarray(v, dtype=np.uint64) for k, v in out.items()}


@pytest.mark.parametrize("arm", list(ARMS))
def test_gl_arm_matches_reference(arm):
    _, plans = _plans()
    want = _reference()
    a, b = _inputs()
    bat = plans[arm].make_batched(B)
    f = bat["fwd"](a)
    got = {"fwd": f, "inv": bat["inv"](f), "polymul": bat["polymul"](a, b),
           "negacyclic_polymul": plans[arm].negacyclic_polymul(a[0], b[0])}
    for key, value in got.items():
        assert np.array_equal(value, want[key]), key


def test_gl_arms_on_the_flat_split_are_the_fold():
    """wmat_fold and wmat_factored do not apply to a flat split, as in the
    reference: it builds the fold arm's passes at its internal split."""
    cfg = T.NTTConfig(field=T.GOLDILOCKS, log_n=8)
    for kw in ARMS.values():
        plan = T.build_plan(cfg, device="cpu", **kw)
        assert (plan.wmat_fold, plan.wmat_factored) == (True, False)
        assert plan.passes["cp1"].wmat is not None


def test_gl_mul_broadcasts_over_the_batch():
    rng = np.random.default_rng(9)
    for lead, tail in (((3,), (8, 16)), ((2, 2), (40,))):
        a = M.gl_from_u64(_values(rng, lead + tail), "cpu")
        b = M.gl_from_u64(_values(rng, tail), "cpu")
        full = tuple(v.expand(lead + tail).contiguous() for v in b)
        got = G.gl_mul(a, b)
        want = G.gl_mul(a, full)
        assert all(torch.equal(u, v) for u, v in zip(got, want))
        assert all(v.is_contiguous() for v in got)
    with pytest.raises(ValueError, match="trailing shape"):
        G.gl_mul(M.gl_from_u64(_values(rng, (3, 8)), "cpu"),
                 M.gl_from_u64(_values(rng, (3,)), "cpu"))


def test_gl_negacyclic_broadcast_equals_copied_psi():
    """The batched negacyclic product, which holds psi and psi^-1 once at
    the split's shape, equals the product by psi copied over the batch."""
    cfg, plans = _plans()
    n1, n2 = cfg.split
    plan = plans["fold"]
    bat = plan.make_batched(B)
    a, b = _inputs()
    got = bat["negacyclic_polymul_mat"](a.reshape(B, n1, n2),
                                        b.reshape(B, n1, n2))
    psi, ipsi = (M.gl_from_u64(tw.negacyclic_psi_powers(
        T.GOLDILOCKS, cfg.n, inverse=inv).reshape(n1, n2), "cpu")
        for inv in (False, True))
    psi_b, ipsi_b = (tuple(v.expand(B, n1, n2).contiguous() for v in t)
                     for t in (psi, ipsi))
    ta, tb = (G.gl_mul(M.gl_from_u64(v.reshape(B, n1, n2), "cpu"), psi_b)
              for v in (a, b))
    cyc = plan.make_batched(B)["polymul_mat"](ta, tb)
    want = M.gl_to_u64(*G.gl_mul(cyc, ipsi_b))
    assert np.array_equal(got, want)


def test_gl_fold_passes_arms():
    """gl_fold_passes builds each arm's tables: the full matrix (fold,
    entry) or the factored tables only (factored)."""
    fac = gl_fold_passes(T.GOLDILOCKS, 16, 32, wmat_factored=True,
                         device="cpu")
    assert fac["cp2"].wfac[0].shape == (32 // 4, 16)
    assert fac["cp2"].wfac[1].shape == (4, 16)
    assert fac["icp2"].wfac_pos == "post" and fac["icp2"].transpose_out
    entry = gl_fold_passes(T.GOLDILOCKS, 16, 32, wmat_fold=False,
                           device="cpu")
    assert entry["cp2"].pre.shape == (32, 16)
    assert entry["icp1"].pre.shape == (16, 32)
    # a 'post' matrix (the distributed plan's, untransposed) is taken
    # now; a position the reference does not name is refused
    post = G.make_gl_colpass(T.GOLDILOCKS, 16, direction="dif",
                             wmat=np.ones((16, 8), np.uint64),
                             twiddle_pos="post", device="cpu")
    assert post.post.shape == (16, 8) and post.pre is None
    with pytest.raises(ValueError, match="twiddle position"):
        G.make_gl_colpass(T.GOLDILOCKS, 16, direction="dif",
                          wmat=np.ones((16, 8), np.uint64),
                          twiddle_pos="mid", device="cpu")
