"""The port's Goldilocks distributed four-step plan
(parallel/fourstep.py build_gl_distributed_plan) on four gloo ranks on
the CPU, against the JAX package: its single-chip Goldilocks plan at the
same split, and where a case names one its distributed plan on the
virtual devices of tests/conftest.py (XLA engine). The cases mirror
tests/test_distributed.py's Goldilocks ones on four ranks (D = 8 runs in
test_torch_dist_plan.py): flat D = 4, the factored and the full-matrix
arm, negacyclic, overlap_chunks 2, a 2 x 2 dp mesh (also chunked) and a
2 x 2 hierarchical mesh (also chunked). Bit-exact throughout. The ranks
are spawned once for the module and drive every case with the plain
column passes; inputs come from a NumPy seed."""

import functools
import zlib

import numpy as np
import pytest

from ntt_aie_tpu import fields as jF
from ntt_aie_tpu.config import NTTConfig as JConfig
from ntt_aie_tpu.parallel import fourstep as jfs
from ntt_aie_tpu.parallel import mesh as jmesh
from ntt_aie_tpu.plan import build_plan as jbuild_plan

from ntt_aie_tpu_torch.parallel import launch, runs

WORLD = 4
GL = jF.GOLDILOCKS
ALL = ("fwd", "inv", "polymul")
NEGA = ALL + ("negacyclic_polymul",)
HIER = {"hier_axes": ("dcn", "ici")}
DP = {"dp_axis": "dp"}
# id -> (log_n, rows_log2, num_shards, negacyclic, mesh, plan keywords,
# batch, calls, JAX distributed oracle: None, or the callables it checks;
# its negacyclic product compiles in ~10 s, so one case checks it)
CASES = {
    "d4": (10, 5, 4, True, ("flat", 4), {}, None, NEGA, None),
    "d4_c2": (10, 5, 4, True, ("flat", 4), {"overlap_chunks": 2}, None,
              NEGA, ("fwd",)),
    "full_d4": (10, 5, 4, True, ("flat", 4), {"wmat_factored": False},
                None, NEGA, ("fwd", "negacyclic_polymul")),
    "full_d4_c2": (10, 5, 4, True, ("flat", 4),
                   {"wmat_factored": False, "overlap_chunks": 2}, None,
                   NEGA, None),
    "dp_2x2": (10, 5, 2, True, ("2d", 2, 2), DP, 4, NEGA, ("fwd",)),
    "dp_2x2_c2": (10, 5, 2, True, ("2d", 2, 2), dict(DP, overlap_chunks=2),
                  4, NEGA, None),
    "hier_2x2_c2": (11, 5, 4, False, ("hier", 2, 2),
                    dict(HIER, overlap_chunks=2), None, ("fwd", "inv"),
                    ("fwd",)),
    "hier_nega": (10, 5, 4, True, ("hier", 2, 2), HIER, None, NEGA, None),
}


def _spec(cid):
    log_n, rows, shards, nega, mesh, plan, batch, calls, _ = CASES[cid]
    rng = np.random.default_rng(zlib.crc32(cid.encode()))
    shape = (1 << log_n,) if batch is None else (batch, 1 << log_n)
    a, b = (rng.integers(0, GL.p, shape, dtype=np.uint64) for _ in range(2))
    return dict(kind="gl", field="goldilocks", log_n=log_n,
                config=dict(rows_log2=rows, num_shards=shards,
                            negacyclic=nega),
                mesh=mesh, plan=plan, a=a, b=b, calls=list(calls))


@pytest.fixture(scope="module")
def ranks():
    specs = [_spec(c) for c in CASES]
    res = launch.run_spmd(runs.run_cases, WORLD, backend="gloo",
                          device_type="cpu", args=(specs, "cpu"))
    return {cid: (i, spec) for i, (cid, spec) in enumerate(zip(CASES, specs))
            }, res


def _port(ranks, cid, call):
    index, res = ranks
    i, spec = index[cid]
    return runs.assemble(res, i, call), spec


@functools.lru_cache(maxsize=None)
def _single(log_n, rows):
    """The JAX package's single-chip Goldilocks plan (XLA) at this split,
    negacyclic planned."""
    cfg = JConfig(field=GL, log_n=log_n, rows_log2=rows, negacyclic=True)
    return jbuild_plan(cfg, engine="xla")


def _rows(x, batch):
    return [x] if batch is None else list(x)


def _flat(out, batch):
    return out.reshape(-1) if batch is None else out.reshape(batch, -1)


def _cases(call):
    return [c for c in CASES if call in CASES[c][7]]


def _u64(pair):
    h, l = (np.asarray(x) for x in pair)
    return (h.astype(np.uint64) << np.uint64(32)) | l.astype(np.uint64)


@pytest.mark.parametrize("cid", _cases("fwd"))
def test_fwd_matches_single_chip(ranks, cid):
    got, spec = _port(ranks, cid, "fwd")
    log_n, rows, *_, batch = CASES[cid][:7]
    plan = _single(log_n, rows)
    want = [np.asarray(plan.fwd(r)) for r in _rows(spec["a"], batch)]
    assert np.array_equal(_flat(got, batch), np.squeeze(np.stack(want)))


@pytest.mark.parametrize("cid", _cases("inv"))
def test_inverse_round_trip(ranks, cid):
    got, spec = _port(ranks, cid, "inv")
    assert np.array_equal(_flat(got, CASES[cid][6]), spec["a"])


@pytest.mark.parametrize("cid", _cases("polymul"))
def test_polymul_matches_single_chip(ranks, cid):
    got, spec = _port(ranks, cid, "polymul")
    log_n, rows, *_, batch = CASES[cid][:7]
    plan = _single(log_n, rows)
    want = [np.asarray(plan.polymul(x, y)) for x, y in
            zip(_rows(spec["a"], batch), _rows(spec["b"], batch))]
    assert np.array_equal(_flat(got, batch), np.squeeze(np.stack(want)))


@pytest.mark.parametrize("cid", _cases("negacyclic_polymul"))
def test_negacyclic_matches_single_chip(ranks, cid):
    got, spec = _port(ranks, cid, "negacyclic_polymul")
    log_n, rows, *_, batch = CASES[cid][:7]
    plan = _single(log_n, rows)
    want = [np.asarray(plan.negacyclic_polymul(x, y)) for x, y in
            zip(_rows(spec["a"], batch), _rows(spec["b"], batch))]
    assert np.array_equal(_flat(got, batch), np.squeeze(np.stack(want)))


def _jax_mesh(kind):
    return {"flat": jmesh.make_mesh, "2d": jmesh.make_mesh_2d,
            "hier": jmesh.make_mesh_hier}[kind[0]](*kind[1:])


@pytest.mark.parametrize("cid", [c for c in CASES if CASES[c][8]])
def test_matches_jax_distributed(ranks, cid):
    log_n, rows, shards, nega, mesh, plan_kw, batch, calls, _ = CASES[cid]
    cfg = JConfig(field=GL, log_n=log_n, rows_log2=rows, num_shards=shards,
                  negacyclic=nega)
    plan = jfs.build_gl_distributed_plan(cfg, _jax_mesh(mesh), engine="xla",
                                         **plan_kw)
    got, spec = _port(ranks, cid, "fwd")
    assert np.array_equal(got, _u64(plan.fwd(plan.shard_input(spec["a"]))))
    if "negacyclic_polymul" in CASES[cid][8]:
        got, _ = _port(ranks, cid, "negacyclic_polymul")
        want = _u64(plan.negacyclic_polymul(plan.shard_input(spec["a"]),
                                            plan.shard_input(spec["b"])))
        assert np.array_equal(got, want)
