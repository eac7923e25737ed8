"""NTTContext(mesh=) and RNSPolymul(mesh=) of the port on four gloo ranks
on the CPU, against the JAX package's NTTContext and RNSPolymul on the
virtual devices of tests/conftest.py (XLA engine): the 32-bit context in
natural and in spectral (bit-reversed four-step) order, the Goldilocks
context in spectral order, flat and over a hierarchical mesh, and the
exact RNS product over a flat mesh and a 2 x 2 dp mesh. Bit-exact
throughout.
The context's refusals are the reference's (same exception types, in
the parent: they come before any collective). The ranks are spawned once
for the module; inputs come from a NumPy seed."""

import functools
import zlib

import numpy as np
import pytest

from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import rns as jrns
from ntt_aie_tpu.api import NTTContext as JContext
from ntt_aie_tpu.config import NTTConfig as JConfig
from ntt_aie_tpu.parallel import mesh as jmesh

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch.parallel import launch, runs

WORLD = 4
P = jF.P_469762049.p
GL = jF.GOLDILOCKS
ALL = ["fwd", "inv", "polymul", "negacyclic_polymul"]
# id -> (field, log_n, NTTConfig keywords, mesh, context/RNS keywords,
# batch, calls)
CASES = {
    "natural": ("p469762049", 12, dict(rows_log2=5, num_shards=4,
                                       ordering="natural", negacyclic=True),
                ("flat", 4), {"overlap_chunks": 2}, None, ALL),
    "spectral": ("p469762049", 12, dict(rows_log2=5, num_shards=4,
                                        negacyclic=True),
                 ("flat", 4), {"wmat_factored": True, "overlap_chunks": 2},
                 None, ALL),
    "gl_spectral": ("goldilocks", 10, dict(rows_log2=5, num_shards=4,
                                           negacyclic=True),
                    ("flat", 4), {"overlap_chunks": 2}, None, ["fwd", "inv"]),
    "gl_hier": ("goldilocks", 11, dict(rows_log2=5, num_shards=4),
                ("hier", 2, 2), {"hier_axes": ("dcn", "ici")}, None,
                ["fwd", "inv"]),
    "rns": ("p469762049", 10, {}, ("flat", 4), {"overlap_chunks": 2}, None,
            ["polymul"]),
    "rns_dp": ("p469762049", 10, {}, ("2d", 2, 2), {"dp_axis": "dp"}, 4,
               ["polymul"]),
}


def _inputs(cid):
    field, log_n, cfg, mesh, kw, batch, calls = CASES[cid]
    rng = np.random.default_rng(zlib.crc32(cid.encode()))
    shape = (1 << log_n,) if batch is None else (batch, 1 << log_n)
    if cid.startswith("rns"):
        return tuple(rng.integers(-(1 << 30), 1 << 30, shape)
                     for _ in range(2))
    if field == "goldilocks":
        return tuple(rng.integers(0, GL.p, shape, dtype=np.uint64)
                     for _ in range(2))
    return tuple(rng.integers(0, P, shape) for _ in range(2))


def _spec(cid):
    field, log_n, cfg, mesh, kw, batch, calls = CASES[cid]
    a, b = _inputs(cid)
    return dict(kind="rns" if cid.startswith("rns") else "context",
                field=field, log_n=log_n, config=cfg, mesh=mesh, plan=kw,
                a=a, b=b, calls=calls)


@pytest.fixture(scope="module")
def ranks():
    specs = [_spec(c) for c in CASES]
    res = launch.run_spmd(runs.run_cases, WORLD, backend="gloo",
                          device_type="cpu", args=(specs, "cpu"))
    return {cid: i for i, cid in enumerate(CASES)}, res


def _jmesh(kind):
    return {"flat": jmesh.make_mesh, "2d": jmesh.make_mesh_2d,
            "hier": jmesh.make_mesh_hier}[kind[0]](*kind[1:])


@functools.lru_cache(maxsize=None)
def _jcontext(cid):
    field, log_n, cfg, mesh, kw, _, _ = CASES[cid]
    jcfg = JConfig(field=GL if field == "goldilocks" else jF.P_469762049,
                   log_n=log_n, **cfg)
    extra = {} if field == "goldilocks" else {"engine": "xla"}
    return JContext(jcfg, mesh=_jmesh(mesh), **kw, **extra)


@functools.lru_cache(maxsize=None)
def _want(cid, call):
    ctx = _jcontext(cid)
    a, b = _inputs(cid)
    if call == "fwd":
        return ctx.forward(a)
    if call == "inv":
        return ctx.inverse(_want(cid, "fwd"))
    return getattr(ctx, call)(a, b)


def _as_host(v, gl):
    v = np.asarray(v)
    return v if gl else v.astype(np.int64)


@pytest.mark.parametrize("cid,call", [(c, k) for c in CASES
                                      if not c.startswith("rns")
                                      for k in CASES[c][6]])
def test_context_matches_reference(ranks, cid, call):
    index, res = ranks
    gl = CASES[cid][0] == "goldilocks"
    natural = CASES[cid][2].get("ordering") == "natural"
    if natural:  # every rank holds the whole flat vector
        outs = [r[index[cid]]["out"][call] for r in res]
        assert all(np.array_equal(o, outs[0]) for o in outs)
        got = outs[0]
    else:
        got = runs.assemble(res, index[cid], call)
    want = _as_host(_want(cid, call), gl)
    assert np.array_equal(got.reshape(-1), want.reshape(-1))


@pytest.mark.parametrize("cid", [c for c in CASES if c.startswith("rns")])
def test_rns_matches_reference(ranks, cid):
    index, res = ranks
    field, log_n, cfg, mesh, kw, batch, _ = CASES[cid]
    a, b = _inputs(cid)
    # every rank of a dp group holds that group's rows
    by_dp = {r[index[cid]]["dp"]: r[index[cid]]["out"]["polymul"]
             for r in res if r[index[cid]]["in_mesh"]}
    got = (by_dp[0] if batch is None
           else np.concatenate([by_dp[k] for k in sorted(by_dp)]))
    jr = jrns.RNSPolymul(log_n, negacyclic=cfg.get("negacyclic", False),
                         engine="xla", mesh=_jmesh(mesh), **kw)
    want = np.asarray(jr.polymul(a, b))
    assert got.shape == want.shape
    assert all(int(x) == int(y) for x, y in zip(got.ravel(), want.ravel()))


def _refusal_cases():
    cfg = dict(field=jF.P_469762049, log_n=12, rows_log2=5, num_shards=8)
    tcfg = dict(field=T.P_469762049, log_n=12, rows_log2=5, num_shards=8)
    gl = dict(field=GL, log_n=10, rows_log2=5, num_shards=8)
    tgl = dict(field=T.GOLDILOCKS, log_n=10, rows_log2=5, num_shards=8)
    ref_conv = dict(field=jF.KYBER, log_n=11, table_convention="reference")
    tref_conv = dict(field=T.KYBER, log_n=11, table_convention="reference")
    return [
        # (reference config, port config, context keywords, what to call)
        (ref_conv, tref_conv, {}, None),
        (dict(cfg, ordering="natural"), dict(tcfg, ordering="natural"),
         {"dp_axis": "dp"}, None),
        (gl, tgl, {"dp_axis": "dp"}, "plan"),
        (cfg, tcfg, {}, "make_batched"),
    ]


@pytest.mark.parametrize("case", range(4))
def test_context_refusals_match_reference(case):
    jcfg, tcfg, kw, call = _refusal_cases()[case]

    def drive(make):
        ctx = make()
        if call == "plan":
            return ctx.plan
        if call == "make_batched":
            return ctx.make_batched(2)

    with pytest.raises(Exception) as jerr:
        drive(lambda: JContext(JConfig(**jcfg), mesh=jmesh.make_mesh(8),
                               **kw))
    with pytest.raises(type(jerr.value)):
        drive(lambda: T.NTTContext(T.NTTConfig(**tcfg), mesh=object(),
                                   device="cpu", **kw))


def test_distributed_kwargs_need_a_mesh():
    cfg = T.NTTConfig(field=T.P_469762049, log_n=12, rows_log2=5)
    with pytest.raises(TypeError, match="need mesh="):
        T.NTTContext(cfg, device="cpu", overlap_chunks=2)
    with pytest.raises(TypeError, match="need mesh="):
        JContext(JConfig(field=jF.P_469762049, log_n=12, rows_log2=5),
                 overlap_chunks=2)
