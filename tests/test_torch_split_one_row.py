"""The split (1, n): a column pass of one row, on the CPU.

NTTConfig(rows_log2=0) pins the four-step split (1, n), which the JAX
package builds and computes; its column of one row is a network of zero
stages, whose pass still multiplies by its operands ('pre', 'post',
'post_t'), transposes and canonicalizes (csrc/colpass_tile.cuh
column_empty on the card). Here the port's plans at n = 2^10 equal the JAX
package's XLA plans bit for bit, spectral order included, for p =
2013265921, p = 469762049 and Goldilocks, on the fold, fused, entry
(wmat_fold=False) and factored (wmat_factored=True) arms (Goldilocks has no
fused plan), cyclic and negacyclic: every batched callable against the JAX
package, and the matrix forms and the unbatched callables against the
batched ones. The plans keep the reference's pass names, and the one-row
passes are one launch each.

The card: tests/test_torch_cuda.py (-m cuda) and chip_smoke.py phase 41.
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
from ntt_aie_tpu_torch.ops import colpass as C

LOG_N = 10
B = 2
ARMS = {"fold": {}, "fused": {"fused": True},
        "entry": {"wmat_fold": False}, "factored": {"wmat_factored": True}}
CASES = [(name, arm) for name in ("p2013265921", "p469762049", "goldilocks")
         for arm in ARMS if not (name == "goldilocks" and arm == "fused")]
KEYS = ("fwd", "inv", "polymul", "negacyclic_polymul")


@functools.lru_cache(maxsize=None)
def _inputs(name):
    rng = np.random.default_rng([LOG_N, len(name)])
    p, n = T.FIELDS[name].p, 1 << LOG_N
    if name == "goldilocks":
        return tuple(rng.integers(0, 1 << 64, (B, n), dtype=np.uint64)
                     % np.uint64(p) for _ in range(2))
    return tuple(rng.integers(0, p, (B, n)) for _ in range(2))


def _call(bat, key, a, b):
    if key == "inv":  # the round trip's inverse, on the JAX package's fwd
        return bat["inv"](a)
    return bat[key](a) if key == "fwd" else bat[key](a, b)


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX package's outputs of every callable (the XLA engine, whose
    outputs every arm's are), as uint64 arrays."""
    jc = jcfg.NTTConfig(field=jF.FIELDS[name], log_n=LOG_N, rows_log2=0,
                        negacyclic=True)
    bat = jplan.build_plan(jc, engine="xla").make_batched(B)
    a, b = _inputs(name)
    if name != "goldilocks":
        a, b = (jnp.asarray(v, jnp.uint32) for v in (a, b))
    out = {}
    for key in KEYS:
        arg = out["fwd"] if key == "inv" else a
        if key == "inv" and name != "goldilocks":
            arg = jnp.asarray(arg.astype(np.uint32))
        out[key] = np.asarray(_call(bat, key, arg, b)).astype(np.uint64)
    return out


def _u64(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.numpy().astype(np.int64).astype(np.uint64) & np.uint64(
            0xFFFFFFFF)
    return np.asarray(v, np.uint64)


@pytest.mark.parametrize("name,arm", CASES)
def test_one_row_split_matches_the_jax_package(name, arm):
    cfg = T.NTTConfig(field=T.FIELDS[name], log_n=LOG_N, rows_log2=0,
                      negacyclic=True)
    assert cfg.split == (1, 1 << LOG_N)
    plan = T.build_plan(cfg, device="cpu", **ARMS[arm])
    want = _jax(name)
    a, b = _inputs(name)
    gl = name == "goldilocks"
    if not gl:
        a, b = torch.from_numpy(a), torch.from_numpy(b)
    bat = plan.make_batched(B)
    got = {}
    for key in KEYS:
        arg = a
        if key == "inv":
            arg = (want["fwd"] if gl else torch.from_numpy(
                want["fwd"].astype(np.int64)))
        got[key] = _call(bat, key, arg, b)
        assert np.array_equal(_u64(got[key]), want[key]), key
    # the unbatched callables, and the matrix forms, on the same values
    n1, n2 = cfg.split
    one = plan.fwd(a[0])
    assert np.array_equal(_u64(one), want["fwd"][0])
    if gl:
        return
    assert torch.equal(bat["fwd_mat"](a.reshape(B, n1, n2)).reshape(B, -1),
                       got["fwd"])
    assert torch.equal(bat["inv_mat"](bat["fwd_mat"](a.reshape(B, n1, n2))),
                       a.reshape(B, n1, n2).to(torch.int32))
    assert torch.equal(bat["polymul_mat"](a.reshape(B, n1, n2),
                                          b.reshape(B, n1, n2)).reshape(B, -1),
                       got["polymul"])
    assert torch.equal(
        bat["negacyclic_polymul_mat"](a.reshape(B, n1, n2),
                                      b.reshape(B, n1, n2)).reshape(B, -1),
        got["negacyclic_polymul"])


@pytest.mark.parametrize("name", ["p469762049", "goldilocks"])
def test_one_row_passes_keep_their_names(name):
    """The reference's pass names, and one launch for each one-row pass
    (no stage: ts empty, operands alone)."""
    cfg = T.NTTConfig(field=T.FIELDS[name], log_n=LOG_N, rows_log2=0,
                      negacyclic=True)
    plan = T.build_plan(cfg, device="cpu")
    want = {"cp1", "cp2", "icp2", "icp1"}
    if name != "goldilocks":
        want |= {"ncp1", "nicp1"}
    assert set(plan.passes) == want
    item = 8 if name == "goldilocks" else 4
    for key in ("cp1", "icp1") + (("ncp1", "nicp1") if len(want) > 4
                                  else ()):
        cp = plan.passes[key]
        assert cp.nn == 1 and cp.phases_ts == ((),) and cp.offsets == ()
        launches = C.launch_plan(cp, 1 << LOG_N, itemsize=item)
        assert len(launches) == 1 and launches[0]["ts"] == ()
    fused = T.build_plan(T.NTTConfig(field=T.P_469762049, log_n=LOG_N,
                                     rows_log2=0), device="cpu", fused=True)
    assert fused.passes["ff"].net_a.nn == 1
    assert fused.passes["fi"].net_b.nn == 1
