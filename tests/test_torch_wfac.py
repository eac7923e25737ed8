"""The 32-bit wmat_factored=True arm (CPU: the plain column passes).

The column pass's factored 'wfac' operand (twiddles.fourstep_wfac_T: the
four-step matrix as T1[c1] * T2[c0] over the row c = c1*S + c0) and its
rank-1 operand (twiddles.negacyclic_psi_factors: psi as row[r] * col[c])
against the reference Pallas kernel in interpret mode, harvey4 at
nn = 32, ncols = 16, B = 2, at the placements the factored plan runs: wfac
'pre' on a DIF pass (cp2), wfac 'post' on a transposing DIT pass (icp2),
rank-1 'pre' on a transposing DIF pass (ncp1) and rank-1 'post' on a DIT
pass (nicp1). Outputs are compared raw: the DIF passes run the
reference's operations and the DIT passes canonicalize (the reference's
DIT lazy bits differ by design, its canonical values do not).

Then the factored plan against the port's fold plan, bit for bit on every
callable, under every 32-bit reduction with the negacyclic product, and
its flat callables against the JAX package's plan on its XLA engine
(whose outputs are those of its factored Pallas plan: its own tests pin
that). The port's plans run on one intra-op thread (see
test_torch_red_plans.py).
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu import config as jcfg
from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import plan as jplan
from ntt_aie_tpu import twiddles as jtw
from ntt_aie_tpu.ops import pallas_ntt as PN

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.ops import colpass as C

B = 2
NN, NCOLS = 32, 16
# name -> (direction, operand, position, transpose_out, canonicalize)
PLACEMENTS = {
    "wfac_pre": ("dif", "wfac", "pre", False, True),
    "wfac_post+T": ("dit", "wfac", "post", True, True),
    "rank1_pre+T": ("dif", "rank1", "pre", True, False),
    "rank1_post": ("dit", "rank1", "post", False, True),
}
# (field name, log_n, rows_log2): each reduction on the field where 'auto'
# picks it, as tests/test_torch_wmat_entry.py's CONFIGS
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


def _tables(operand):
    """The host tables of one operand, made as the plans make them: the
    factored matrix of the (NCOLS, NN) split over the pass's NN rows, or
    the psi factors of the (NN, NCOLS) split."""
    if operand == "wfac":
        return tw.fourstep_wfac_T(T.P_469762049, NCOLS, NN)
    return tw.negacyclic_psi_factors(T.P_469762049, NN, NCOLS)


@pytest.mark.parametrize("name", list(PLACEMENTS))
def test_factored_plain_matches_pallas(name):
    direction, operand, pos, transpose, canon = PLACEMENTS[name]
    tabs = _tables(operand)
    jcp = PN.make_colpass(jF.P_469762049, NN, NCOLS, reduction="harvey4",
                          direction=direction, inverse_tw=direction == "dit",
                          canonicalize=canon, transpose_out=transpose,
                          batch=B, interpret=True,
                          **{operand: tabs, f"{operand}_pos": pos})
    p = T.P_469762049.p
    rng = np.random.default_rng(len(name))
    x = rng.integers(0, 4 * p, (B, NN, NCOLS)).astype(np.uint32)
    want = np.asarray(jcp(jnp.asarray(x)))
    cp = C.make_colpass(T.P_469762049, NN, direction=direction,
                        inverse_tw=direction == "dit", canonicalize=canon,
                        transpose_out=transpose, device="cpu",
                        **{operand: tabs, f"{operand}_pos": pos})
    assert C.variant(cp) == f"{direction}+{name}"
    got = C.colpass(torch.from_numpy(x.view(np.int32)), cp)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_factored_operands_equal_their_full_tables():
    """wfac equals the full four-step matrix as a 'pre' operand, rank-1 psi
    the full psi matrix: the canonical outputs, under every reduction."""
    for kind, fname in (("harvey4", "p469762049"), ("harvey", "p998244353"),
                        ("montgomery", "p2013265921"), ("barrett", "kyber")):
        field = T.FIELDS[fname]
        n1, n2 = 8, 16
        wmat_t = tw.fourstep_tables(field, n1, n2)["wmat"].T
        psi = tw.negacyclic_psi_powers(field, n1 * n2).reshape(n1, n2)
        rng = np.random.default_rng(n1)
        kw = dict(direction="dif", canonicalize=True, reduction=kind,
                  device="cpu")
        for rows, full, fac in (
                (n2, dict(wmat=wmat_t, twiddle_pos="pre"),
                 dict(wfac=tw.fourstep_wfac_T(field, n1, n2),
                      wfac_pos="pre")),
                (n1, dict(wmat=psi, twiddle_pos="pre"),
                 dict(rank1=tw.negacyclic_psi_factors(field, n1, n2),
                      rank1_pos="pre"))):
            cols = n1 * n2 // rows
            x = torch.from_numpy(rng.integers(0, field.p, (B, rows, cols))
                                 .astype(np.int32))
            assert torch.equal(
                C.colpass(x, C.make_colpass(field, rows, **fac, **kw)),
                C.colpass(x, C.make_colpass(field, rows, **full, **kw))), kind


def test_factored_operands_reject_bad_tables():
    field = T.P_469762049
    t1, t2 = tw.fourstep_wfac_T(field, 16, 32)
    with pytest.raises(ValueError, match="wfac_pos"):
        C.make_colpass(field, 32, direction="dif", wfac=(t1, t2),
                       wfac_pos="post_t", device="cpu")
    with pytest.raises(ValueError, match="wfac tables"):
        C.make_colpass(field, 16, direction="dif", wfac=(t1, t2),
                       wfac_pos="pre", device="cpu")
    row, col = tw.negacyclic_psi_factors(field, 32, 16)
    with pytest.raises(ValueError, match="rank1 vectors"):
        C.make_colpass(field, 16, direction="dif", rank1=(row, col),
                       rank1_pos="pre", device="cpu")
    cp = C.make_colpass(field, 32, direction="dif", rank1=(row, col),
                        rank1_pos="pre", device="cpu")
    with pytest.raises(ValueError, match="rank1 operand has 16 columns"):
        C.colpass(torch.zeros(1, 32, 8, dtype=torch.int32), cp)
    # the kernel takes one form a position: a wfac and a rank-1 'pre' raise
    both = C.make_colpass(field, 32, direction="dif", wfac=(t1, t2),
                          wfac_pos="pre", rank1=(row, col), rank1_pos="pre",
                          device="cpu")
    assert C.variant(both) == "dif+wfac_pre+rank1_pre"
    with pytest.raises(ValueError, match="one 'pre' operand"):
        C._operand_forms(both)


def _inputs(name, log_n):
    p = T.FIELDS[name].p
    rng = np.random.default_rng([log_n, p, 13])
    return rng.integers(0, p, (2, B, 1 << log_n))


@functools.lru_cache(maxsize=None)
def _plans(name, log_n, rows_log2):
    cfg = T.NTTConfig(field=T.FIELDS[name], log_n=log_n, rows_log2=rows_log2,
                      negacyclic=True)
    return cfg, {fac: T.build_plan(cfg, device="cpu", wmat_factored=fac)
                 for fac in (False, True)}


def _operands(key, cfg, a, b):
    n1, n2 = cfg.split
    if key == "inv_mat":
        return (a.reshape(B, n2, n1),)
    shape = (B, n1, n2) if key.endswith("_mat") else (B, cfg.n)
    ops = (a, b) if "polymul" in key else (a,)
    return tuple(v.reshape(shape) for v in ops)


@pytest.mark.parametrize("key", CALLABLES)
@pytest.mark.parametrize("name,log_n,rows_log2", CONFIGS)
def test_factored_plan_equals_fold(name, log_n, rows_log2, key):
    cfg, plans = _plans(name, log_n, rows_log2)
    fac = plans[True]
    assert (fac.wmat_factored, fac.wmat_fold) == (True, False)
    assert (plans[False].wmat_factored, plans[False].wmat_fold) == (False,
                                                                    True)
    variants = {k: C.variant(cp) for k, cp in fac.passes.items()}
    assert variants == {"cp1": "dif+T", "cp2": "dif+wfac_pre",
                        "icp2": "dit+wfac_post+T", "icp1": "dit",
                        "ncp1": "dif+rank1_pre+T", "nicp1": "dit+rank1_post"}
    a, b = (torch.from_numpy(v) for v in _inputs(name, log_n))
    got = fac.make_batched(B)[key](*_operands(key, cfg, a, b))
    want = plans[False].make_batched(B)[key](*_operands(key, cfg, a, b))
    assert torch.equal(got, want)


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


@pytest.mark.parametrize("name,log_n,rows_log2", CONFIGS)
def test_factored_plan_matches_reference(name, log_n, rows_log2):
    cfg, plans = _plans(name, log_n, rows_log2)
    want = _reference(name, log_n, rows_log2)
    a, b = (torch.from_numpy(v) for v in _inputs(name, log_n))
    bat = plans[True].make_batched(B)
    f = bat["fwd"](a)
    got = {"fwd": f, "inv": bat["inv"](f), "polymul": bat["polymul"](a, b),
           "negacyclic_polymul": bat["negacyclic_polymul"](a, b)}
    for key, value in got.items():
        assert np.array_equal(value.numpy().astype(np.int64) & 0xFFFFFFFF,
                              want[key]), key
    assert np.array_equal(plans[True].fwd(a[0]).numpy(), want["fwd"][0])


def test_factored_reference_tables_feed_the_port():
    """The reference's own factored tables through the port's pass equal
    the port's tables (the two copies agree where a plan uses them)."""
    jt = jtw.fourstep_wfac_T(jF.P_469762049, NCOLS, NN)
    tt = tw.fourstep_wfac_T(T.P_469762049, NCOLS, NN)
    kw = dict(direction="dif", canonicalize=True, wfac_pos="pre",
              device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, T.P_469762049.p, (B, NN, NCOLS)).astype(np.int32))
    assert torch.equal(
        C.colpass(x, C.make_colpass(T.P_469762049, NN, wfac=jt, **kw)),
        C.colpass(x, C.make_colpass(T.P_469762049, NN, wfac=tt, **kw)))
