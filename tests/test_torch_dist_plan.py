"""The port's 32-bit distributed four-step plan (parallel/fourstep.py) on
eight gloo ranks on the CPU, against the JAX package: its single-chip plan
at the same split (XLA engine), and where a case names one its
distributed plan on the 8-virtual-device mesh of tests/conftest.py (XLA
engine). The cases mirror tests/test_distributed.py: D = 2, 4, 8; the
factored and the full-matrix arm; cyclic and negacyclic; montgomery
(p = 2013265921); overlap_chunks C = 1, 2, 4; a 2 x 4 dp mesh; 2 x 4 and
4 x 2 hierarchical meshes, also under dp (2 x 2 x 2) and with chunks; and
the pairwise mode. Bit-exact throughout (np.array_equal). The ranks are
spawned once for the module (run_spmd) and drive every case with the
plain column passes; inputs come from a NumPy seed."""

import functools
import zlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import reference as jref
from ntt_aie_tpu.config import NTTConfig as JConfig
from ntt_aie_tpu.parallel import fourstep as jfs
from ntt_aie_tpu.parallel import mesh as jmesh
from ntt_aie_tpu.plan import build_plan as jbuild_plan

from ntt_aie_tpu_torch.parallel import launch, runs

WORLD = 8
FIELDS = {"p469762049": jF.P_469762049, "p2013265921": jF.P_2013265921}
ALL = ("fwd", "inv", "polymul")
NEGA = ALL + ("negacyclic_polymul",)
HIER = {"hier_axes": ("dcn", "ici")}
DP = {"dp_axis": "dp"}
# id -> (field, log_n, rows_log2, num_shards, negacyclic, mesh, plan
# keywords, batch, calls, JAX distributed oracle)
CASES = {
    "d2": ("p469762049", 12, 5, 2, False, ("flat", 2), {}, None,
           ("fwd", "inv"), False),
    "d4": ("p469762049", 12, 5, 4, False, ("flat", 4), {}, None, ALL,
           False),
    "d8": ("p469762049", 12, 5, 8, False, ("flat", 8), {}, None, ALL,
           True),
    "d8_13": ("p469762049", 13, 6, 8, False, ("flat", 8), {}, None,
              ("fwd", "inv"), False),
    "d8_c2": ("p469762049", 13, 6, 8, False, ("flat", 8),
              {"overlap_chunks": 2}, None, ("fwd", "inv"), True),
    "d8_c4": ("p469762049", 13, 6, 8, False, ("flat", 8),
              {"overlap_chunks": 4}, None, ("fwd", "inv"), False),
    "nega_d8": ("p469762049", 12, 5, 8, True, ("flat", 8), {}, None, NEGA,
                False),
    "nega_d8_c2": ("p469762049", 12, 5, 8, True, ("flat", 8),
                   {"overlap_chunks": 2}, None, NEGA, True),
    "full_d8": ("p469762049", 12, 5, 8, True, ("flat", 8),
                {"wmat_factored": False}, None, NEGA, True),
    "full_d8_c2": ("p469762049", 12, 5, 8, True, ("flat", 8),
                   {"wmat_factored": False, "overlap_chunks": 2}, None,
                   NEGA, False),
    "full_d4_c4": ("p469762049", 12, 5, 4, False, ("flat", 4),
                   {"wmat_factored": False, "overlap_chunks": 4}, None,
                   ALL, False),
    "mont_d8": ("p2013265921", 12, 5, 8, True, ("flat", 8), {}, None, NEGA,
                True),
    "mont_full_d8": ("p2013265921", 12, 5, 8, True, ("flat", 8),
                     {"wmat_factored": False}, None, NEGA, False),
    "dp_2x4": ("p469762049", 12, 5, 4, False, ("2d", 2, 4), DP, 4, ALL,
               True),
    "dp_2x4_c2": ("p469762049", 12, 6, 4, False, ("2d", 2, 4),
                  dict(DP, overlap_chunks=2), 4, ("fwd", "inv"), False),
    "hier_2x4": ("p469762049", 13, 6, 8, False, ("hier", 2, 4), HIER, None,
                 ("fwd", "inv"), True),
    "hier_4x2": ("p469762049", 13, 6, 8, False, ("hier", 4, 2), HIER, None,
                 ("fwd", "inv"), False),
    "hier_2x4_c2": ("p469762049", 13, 6, 8, False, ("hier", 2, 4),
                    dict(HIER, overlap_chunks=2), None, ("fwd", "inv"),
                    False),
    "hier_nega": ("p469762049", 12, 5, 8, True, ("hier", 2, 4), HIER, None,
                  NEGA, False),
    "hier_dp": ("p469762049", 12, 6, 4, False, ("3d", 2, 2, 2),
                dict(HIER, **DP), 4, ("fwd", "inv"), True),
    "hier_dp_c2": ("p469762049", 12, 6, 4, False, ("3d", 2, 2, 2),
                   dict(HIER, overlap_chunks=2, **DP), 4, ("fwd", "inv"),
                   False),
}
# the pairwise mode: id -> (log_n, D)
PAIRWISE = {"pairwise_d8": (10, 8), "pairwise_d4": (10, 4)}


def _inputs(cid, p, n, batch):
    rng = np.random.default_rng(zlib.crc32(cid.encode()))
    shape = (n,) if batch is None else (batch, n)
    return rng.integers(0, p, shape), rng.integers(0, p, shape)


def _spec(cid):
    field, log_n, rows, shards, nega, mesh, plan, batch, calls, _ = \
        CASES[cid]
    a, b = _inputs(cid, FIELDS[field].p, 1 << log_n, batch)
    return dict(kind="plan", field=field, log_n=log_n,
                config=dict(rows_log2=rows, num_shards=shards,
                            negacyclic=nega),
                mesh=mesh, plan=plan, a=a, b=b, calls=list(calls))


def _pair_spec(cid):
    log_n, D = PAIRWISE[cid]
    a, _ = _inputs(cid, FIELDS["p469762049"].p, 1 << log_n, None)
    return dict(kind="pairwise", field="p469762049", log_n=log_n,
                config=dict(num_shards=D), mesh=("flat", D), a=a,
                calls=["fwd"])


@pytest.fixture(scope="module")
def ranks():
    ids = list(CASES) + list(PAIRWISE)
    specs = [_spec(c) for c in CASES] + [_pair_spec(c) for c in PAIRWISE]
    res = launch.run_spmd(runs.run_cases, WORLD, backend="gloo",
                          device_type="cpu", args=(specs, "cpu"))
    return {cid: (i, spec) for i, (cid, spec) in enumerate(zip(ids, specs))}, \
        res


def _port(ranks, cid, call):
    index, res = ranks
    i, spec = index[cid]
    return runs.assemble(res, i, call), spec


@functools.lru_cache(maxsize=None)
def _single(field, log_n, rows):
    """The JAX package's single-chip plan (XLA) at this split; negacyclic
    planned, which changes no other callable."""
    cfg = JConfig(field=FIELDS[field], log_n=log_n, rows_log2=rows,
                  negacyclic=True)
    return jbuild_plan(cfg, engine="xla")


def _j(fn, *xs):
    return np.asarray(fn(*(jnp.asarray(x, jnp.uint32) for x in xs))).astype(
        np.int64)


def _rows(x, batch):
    return [x] if batch is None else list(x)


def _flat(out, batch):
    return out.reshape(-1) if batch is None else out.reshape(batch, -1)


def _cases(call):
    return [c for c in CASES if call in CASES[c][8]]


@pytest.mark.parametrize("cid", _cases("fwd"))
def test_fwd_matches_single_chip(ranks, cid):
    got, spec = _port(ranks, cid, "fwd")
    field, log_n, rows, *_, batch = CASES[cid][:8]
    plan = _single(field, log_n, rows)
    want = [_j(plan.fwd, r) for r in _rows(spec["a"], batch)]
    assert np.array_equal(_flat(got, batch), np.squeeze(np.stack(want)))


@pytest.mark.parametrize("cid", _cases("inv"))
def test_inverse_round_trip(ranks, cid):
    got, spec = _port(ranks, cid, "inv")
    assert np.array_equal(_flat(got, CASES[cid][7]), spec["a"])


@pytest.mark.parametrize("cid", _cases("polymul"))
def test_polymul_matches_single_chip(ranks, cid):
    got, spec = _port(ranks, cid, "polymul")
    field, log_n, rows, *_, batch = CASES[cid][:8]
    plan = _single(field, log_n, rows)
    want = [_j(plan.polymul, x, y) for x, y in
            zip(_rows(spec["a"], batch), _rows(spec["b"], batch))]
    assert np.array_equal(_flat(got, batch), np.squeeze(np.stack(want)))


@pytest.mark.parametrize("cid", _cases("negacyclic_polymul"))
def test_negacyclic_matches_single_chip(ranks, cid):
    got, spec = _port(ranks, cid, "negacyclic_polymul")
    field, log_n, rows = CASES[cid][:3]
    want = _j(_single(field, log_n, rows).negacyclic_polymul, spec["a"],
              spec["b"])
    assert np.array_equal(got.reshape(-1), want)


def _jax_mesh(kind):
    devs = jax.devices()
    if kind[0] == "flat":
        return jmesh.make_mesh(kind[1])
    if kind[0] == "2d":
        return jmesh.make_mesh_2d(*kind[1:])
    if kind[0] == "hier":
        return jmesh.make_mesh_hier(*kind[1:])
    return jax.sharding.Mesh(np.array(devs[:8]).reshape(kind[1:]),
                             ("dp", "dcn", "ici"))


@pytest.mark.parametrize("cid", [c for c in CASES if CASES[c][9]])
def test_matches_jax_distributed(ranks, cid):
    field, log_n, rows, shards, nega, mesh, plan_kw, batch, calls, _ = \
        CASES[cid]
    cfg = JConfig(field=FIELDS[field], log_n=log_n, rows_log2=rows,
                  num_shards=shards, negacyclic=nega)
    plan = jfs.build_distributed_plan(cfg, _jax_mesh(mesh), engine="xla",
                                      **plan_kw)
    got, spec = _port(ranks, cid, "fwd")
    want = np.asarray(plan.fwd(plan.shard_input(spec["a"])))
    assert np.array_equal(got, want.astype(np.int64))
    if nega:
        got, _ = _port(ranks, cid, "negacyclic_polymul")
        want = np.asarray(plan.negacyclic_polymul(
            plan.shard_input(spec["a"]), plan.shard_input(spec["b"])))
        assert np.array_equal(got, want.astype(np.int64))


def test_spectral_order_is_natural_through_positions(ranks):
    from ntt_aie_tpu_torch import twiddles as tw

    got, spec = _port(ranks, "d8_13", "fwd")
    field, log_n, rows = CASES["d8_13"][:3]
    pos = tw.spectral_positions(1 << rows, 1 << (log_n - rows))
    assert np.array_equal(got.reshape(-1)[pos],
                          jref.ntt_forward(spec["a"], FIELDS[field]))


@pytest.mark.parametrize("cid", list(PAIRWISE))
def test_pairwise_matches_reference(ranks, cid):
    index, res = ranks
    i, spec = index[cid]
    got = runs.assemble(res, i, "fwd")
    log_n, D = PAIRWISE[cid]
    cfg = JConfig(field=jF.P_469762049, log_n=log_n, num_shards=D)
    fwd, in_sh = jfs.build_pairwise_plan(cfg, jmesh.make_mesh(D))
    want = np.asarray(fwd(jax.device_put(spec["a"].astype(np.uint32),
                                         in_sh))).astype(np.int64)
    assert np.array_equal(got, want)
    assert np.array_equal(got, jref.ntt_dif(spec["a"], jF.P_469762049))
