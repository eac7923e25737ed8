"""The port's fold and fused plans under harvey, montgomery and barrett
(CPU: the plain column passes and fused transforms), bit for bit: the
plans' outputs are canonical. This file holds the checks and runs them on
harvey and montgomery forced on p = 469762049 (where 'auto' picks
harvey4); test_torch_red_montgomery.py, _harvey.py and _barrett.py run
them on the fields where 'auto' picks each, one file a reduction so that
the reference's interpret-mode compiles spread over the workers.

check_callable holds both port plans against the reference's fold plan
(whose canonical outputs equal its fused plan's, as the reference's own
tests pin), raw in the same spectral order, and against the reference's
NumPy oracles (``ntt_aie_tpu.reference``): the natural-order forward and
the cyclic product on row 0. The reference plan runs its Pallas kernels
in interpret mode (engine "pallas") or its XLA engine ("xla": the same
column networks and spectral order as jitted jnp code, which compiles in
seconds where an interpret-mode kernel takes up to ~35 s). check_negacyclic
holds the fused plan's negacyclic product against the reference's NumPy
oracle on both rows, and with `reference` against the reference's fused
negacyclic plan too. Reference outputs are computed once a configuration.
The port's plans run on one intra-op thread here: under several test
workers a plain plan at n = 2^16 on all cores slows by two orders."""

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
CALLABLES = ["fwd_mat", "inv_mat", "polymul_mat", "fwd", "inv", "polymul"]
PLANS = ["fold", "fused"]


def _cfgs(name, log_n, rows_log2, kind, **kw):
    return (jcfg.NTTConfig(field=jF.FIELDS[name], log_n=log_n,
                           rows_log2=rows_log2, reduction=kind, **kw),
            T.NTTConfig(field=T.FIELDS[name], log_n=log_n,
                        rows_log2=rows_log2, reduction=kind, **kw))


def _inputs(name, log_n, seed=0):
    p = T.FIELDS[name].p
    rng = np.random.default_rng([log_n, p, seed])
    n = 1 << log_n
    return rng.integers(0, p, (B, n)), rng.integers(0, p, (B, n))


def _u32(v):
    return jnp.asarray(np.asarray(v), jnp.uint32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def reference_outputs(name, log_n, rows_log2, kind, engine="pallas"):
    """Every callable of the reference fold plan, make_batched(B); the XLA
    engine's batched dict has the flat callables only, whose outputs are
    the matrix ones' flattened."""
    jc, _ = _cfgs(name, log_n, rows_log2, kind)
    assert jc.resolved_reduction == kind
    n1, n2 = jc.split
    kw = {"interpret": True} if engine == "pallas" else {}
    jb = jplan.build_plan(jc, engine=engine, **kw).make_batched(B)
    a, b = _inputs(name, log_n)
    out = {"fwd": jb["fwd"](_u32(a)),
           "polymul": jb["polymul"](_u32(a), _u32(b))}
    out["inv"] = jb["inv"](out["fwd"])
    if engine == "pallas":
        am, bm = (_u32(v.reshape(B, n1, n2)) for v in (a, b))
        out["fwd_mat"] = jb["fwd_mat"](am)
        out["polymul_mat"] = jb["polymul_mat"](am, bm)
        out["inv_mat"] = jb["inv_mat"](out["fwd_mat"])
    else:
        out["fwd_mat"] = out["fwd"].reshape(B, n2, n1)
        out["polymul_mat"] = out["polymul"].reshape(B, n1, n2)
        out["inv_mat"] = out["inv"].reshape(B, n1, n2)
    return {k: np.asarray(v).astype(np.int64) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def port_plan(name, log_n, rows_log2, kind, plan):
    fused = plan == "fused"
    nega = fused and 2 * (1 << log_n) <= T.FIELDS[name].max_n
    _, tc = _cfgs(name, log_n, rows_log2, kind, negacyclic=nega)
    return T.build_plan(tc, device="cpu", fused=fused)


def check_callable(name, log_n, rows_log2, kind, plan, fn, engine="pallas"):
    """The port plan's batched `fn` equals the reference fold plan's (on
    this engine) and, on row 0, the reference's NumPy oracle."""
    want = reference_outputs(name, log_n, rows_log2, kind, engine)
    tp = port_plan(name, log_n, rows_log2, kind, plan)
    assert tp.reduction == kind
    n1, n2 = tp.config.split
    a, b = (torch.from_numpy(v) for v in _inputs(name, log_n))
    bat = tp.make_batched(B)
    if fn == "fwd_mat":
        got = bat[fn](a.reshape(B, n1, n2))
    elif fn == "inv_mat":
        got = bat[fn](torch.from_numpy(want["fwd_mat"]))
    elif fn == "polymul_mat":
        got = bat[fn](a.reshape(B, n1, n2), b.reshape(B, n1, n2))
    elif fn == "fwd":
        got = bat[fn](a)
    elif fn == "inv":
        got = bat[fn](torch.from_numpy(want["fwd"]))
    else:
        got = bat[fn](a, b)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.int64), want[fn])
    if fn in ("inv_mat", "inv"):  # the roundtrip
        assert np.array_equal(got.numpy().reshape(B, -1), a.numpy())
    field = jF.FIELDS[name]
    if fn in ("fwd_mat", "fwd"):
        spec = got[0].numpy().reshape(-1)[tp.spectral_to_natural]
        assert np.array_equal(spec, jref.ntt_forward(a[0].numpy(), field))
    if fn in ("polymul_mat", "polymul"):
        assert np.array_equal(got[0].numpy().reshape(-1), jref.cyclic_polymul(
            a[0].numpy(), b[0].numpy(), field))


@functools.lru_cache(maxsize=None)
def reference_negacyclic(name, log_n, rows_log2, kind):
    jc, _ = _cfgs(name, log_n, rows_log2, kind, negacyclic=True)
    n1, n2 = jc.split
    jb = jplan.build_plan(jc, engine="pallas", interpret=True,
                          fused=True).make_batched(B)
    a, b = _inputs(name, log_n, seed=1)
    got = jb["negacyclic_polymul_mat"](_u32(a.reshape(B, n1, n2)),
                                       _u32(b.reshape(B, n1, n2)))
    return np.asarray(got).astype(np.int64)


def check_negacyclic(name, log_n, rows_log2, kind, *, reference=True):
    """The port fused plan's batched negacyclic product equals the
    reference's NumPy oracle on both rows, and with `reference` the
    reference fused plan's."""
    _, tc = _cfgs(name, log_n, rows_log2, kind, negacyclic=True)
    tp = T.build_plan(tc, device="cpu", fused=True)
    assert tp.reduction == kind
    n1, n2 = tc.split
    a, b = _inputs(name, log_n, seed=1)
    got = tp.make_batched(B)["negacyclic_polymul_mat"](
        torch.from_numpy(a.reshape(B, n1, n2)),
        torch.from_numpy(b.reshape(B, n1, n2)))
    got = got.numpy().astype(np.int64)
    if reference:
        assert np.array_equal(got, reference_negacyclic(name, log_n,
                                                        rows_log2, kind))
    for r in range(B):
        assert np.array_equal(got[r].reshape(-1), jref.negacyclic_polymul(
            a[r], b[r], jF.FIELDS[name]))


# harvey and montgomery forced on p = 469762049, at (log_n, rows_log2) =
# (11, 4): plain columns of 16 and 128 rows, held against the reference's
# XLA engine
FORCED = [("harvey", 11, 4), ("montgomery", 11, 4)]


@pytest.mark.parametrize("kind,log_n,rows_log2", FORCED)
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("fn", CALLABLES)
def test_forced_reduction_matches_oracles(kind, log_n, rows_log2, plan, fn):
    check_callable("p469762049", log_n, rows_log2, kind, plan, fn,
                   engine="xla")


@pytest.mark.parametrize("kind,log_n,rows_log2", FORCED)
def test_forced_reduction_negacyclic_matches_oracle(kind, log_n,
                                                    rows_log2):
    check_negacyclic("p469762049", log_n, rows_log2, kind, reference=False)
