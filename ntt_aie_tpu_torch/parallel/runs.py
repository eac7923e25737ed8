"""Rank functions that drive the distributed plans, for ``run_spmd``.

A spawned rank re-imports the module of the function it runs, so the
functions live here, in the port (which imports no jax), and not in a
test module. ``run_cases(rank, world, cases, device)`` builds each case's
mesh and plan on every rank and returns what each callable gave this
rank; ``assemble`` puts the ranks' blocks back together in the caller.

A case is a dict:

  kind: 'plan' (build_distributed_plan), 'gl' (build_gl_distributed_plan),
    'pairwise' (build_pairwise_plan), 'context' (NTTContext(mesh=)),
    'rns' (RNSPolymul(mesh=));
  field, log_n, and NTTConfig keywords in 'config' (rows_log2,
    negacyclic, reduction, ordering, num_shards);
  mesh: ('flat', D), ('2d', dp, sp), ('hier', G, L) or ('3d', dp, G, L)
    (axes 'x'; 'dp', 'x'; 'dcn', 'ici'; 'dp', 'dcn', 'ici');
  plan: the builder's keyword arguments;
  a, b: host inputs (flat (n,), or (B, n) with dp_axis);
  calls: the callables to drive, in order ('fwd', 'inv' of fwd's output,
    'polymul', 'negacyclic_polymul');
  time: repeats of each call to time (0: none; a timed case's mesh
    holds every rank). The plans' inputs are placed (shard_input) once,
    before the calls; a context's calls place theirs.

Each rank returns, per case, {'in_mesh', 'shard', 'dp', 'backend', 'out':
{call: array}, 'launches': {kernel: {variant: count}}, 'ms': {call: ms}}: the
column kernels' launches of this rank's driven calls (counted from 0
just before them), and with 'time' the median wall time of a call over
the repeats, each between two barriers after a device synchronize.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

MESH_AXES = {"flat": ("x",), "2d": ("dp", "x"), "hier": ("dcn", "ici"),
             "3d": ("dp", "dcn", "ici")}


def _host(v) -> np.ndarray:
    """A tensor, or a Goldilocks (hi, lo) pair of them, as a host array
    (uint64 values for a pair, the uint32 values of an int32 tensor)."""
    if isinstance(v, tuple):
        from ntt_aie_tpu_torch.ops.modops import gl_to_u64

        return gl_to_u64(*v)
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
        return v.view(np.uint32) if v.dtype == np.int32 else v
    return np.asarray(v)


def _counters() -> dict:
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import gl_colpass as G

    return {"colpass": C.colpass, "gl_colpass": G.gl_colpass}


def _reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0
        fn.launches_by = {}


def _read_counts() -> dict:
    return {name: dict(fn.launches_by) for name, fn in _counters().items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build(case: dict, device, meshes: dict):
    """(mesh, callables {name: fn() -> output}, placement info). meshes
    caches the DeviceMeshes by their case['mesh'] (each new one creates
    process groups, a rendezvous of every rank)."""
    from ntt_aie_tpu_torch import fields as F
    from ntt_aie_tpu_torch.config import NTTConfig
    from ntt_aie_tpu_torch.parallel import fourstep as FS
    from ntt_aie_tpu_torch.parallel import mesh as MS

    kind_shape = tuple(case["mesh"])
    if kind_shape not in meshes:
        meshes[kind_shape] = MS.make_mesh_nd(
            kind_shape[1:], MESH_AXES[kind_shape[0]], device=device,
            backend=dist.get_backend())
    mesh = meshes[kind_shape]
    if not MS.in_mesh(mesh):
        return mesh, None, None
    field = F.FIELDS[case["field"]]
    cfg = NTTConfig(field=field, log_n=case["log_n"],
                    **case.get("config", {}))
    kw = dict(case.get("plan", {}))
    a, b = case.get("a"), case.get("b")
    kind = case["kind"]
    if kind == "pairwise":
        fwd, shard = FS.build_pairwise_plan(cfg, mesh, device=device)
        xa = shard(a)
        return mesh, {"fwd": lambda st: fwd(xa)}, _info(
            MS.axis_index(mesh, cfg.mesh_axis), 0)
    if kind == "rns":
        from ntt_aie_tpu_torch.rns import RNSPolymul

        rns = RNSPolymul(case["log_n"], negacyclic=cfg.negacyclic,
                         mesh=mesh, device=device, **kw)
        return mesh, {"polymul": lambda st: rns.polymul(a, b)}, _info(
            rns.plans[0].shard, _dp_index(mesh, kw))
    if kind == "context":
        from ntt_aie_tpu_torch.api import NTTContext

        ctx = NTTContext(cfg, mesh=mesh, device=device, **kw)
        calls = {"fwd": lambda st: ctx.forward(a),
                 "inv": lambda st: ctx.inverse(st["fwd"]),
                 "polymul": lambda st: ctx.polymul(a, b)}
        if cfg.negacyclic:
            calls["negacyclic_polymul"] = (
                lambda st: ctx.negacyclic_polymul(a, b))
        return mesh, calls, _info(ctx.plan.shard, _dp_index(mesh, kw))
    build = (FS.build_gl_distributed_plan if kind == "gl"
             else FS.build_distributed_plan)
    plan = build(cfg, mesh, device=device, **kw)
    # the host inputs are placed once: a timed call is the plan's alone
    xa = plan.shard_input(a)
    xb = None if b is None else plan.shard_input(b)
    calls = {"fwd": lambda st: plan.fwd(xa),
             "inv": lambda st: plan.inv(st["fwd"]),
             "polymul": lambda st: plan.polymul(xa, xb)}
    if cfg.negacyclic:
        calls["negacyclic_polymul"] = lambda st: plan.negacyclic_polymul(
            xa, xb)
    return mesh, calls, _info(plan.shard, _dp_index(mesh, kw))


def _info(shard: int, dp: int) -> dict:
    return {"shard": shard, "dp": dp}


def _dp_index(mesh, kw) -> int:
    from ntt_aie_tpu_torch.parallel.mesh import axis_index

    return axis_index(mesh, kw["dp_axis"]) if kw.get("dp_axis") else 0


def run_cases(rank: int, world: int, cases: list, device: str) -> list:
    """Drive every case on this rank (every rank builds every case's mesh;
    ranks outside a mesh skip its plan). device: 'cpu' or 'cuda'."""
    device = torch.device(device)
    results, meshes = [], {}
    for case in cases:
        mesh, calls, info = _build(case, device, meshes)
        if calls is None:
            results.append({"in_mesh": False})
            continue
        _sync(device)
        _reset_counts()
        state = {}
        for name in case["calls"]:
            state[name] = calls[name](state)
        _sync(device)
        launches = _read_counts()
        ms = {}
        for name in case["calls"] if case.get("time") else ():
            runs = []
            for _ in range(case["time"]):
                _sync(device)
                dist.barrier()
                t0 = time.perf_counter()
                calls[name](state)
                _sync(device)
                runs.append((time.perf_counter() - t0) * 1e3)
            ms[name] = float(np.median(runs))
        results.append(dict(info, in_mesh=True, launches=launches, ms=ms,
                            backend=dist.get_backend(),
                            out={k: _host(v) for k, v in state.items()}))
    return results


def assemble(results: list, index: int, call: str) -> np.ndarray:
    """The whole output of `call` in case `index` from the ranks' results
    (run_cases): the blocks of each data-parallel group side by side on
    their last axis in shard order, the groups' batch rows stacked."""
    mine = [r[index] for r in results if r[index]["in_mesh"]]
    groups = {}
    for r in mine:
        groups.setdefault(r["dp"], {})[r["shard"]] = r["out"][call]
    rows = [np.concatenate([g[s] for s in sorted(g)], axis=-1)
            for _, g in sorted(groups.items())]
    return rows[0] if len(rows) == 1 else np.concatenate(rows, axis=0)


def probe(rank: int, world: int) -> dict:
    """What a spawned rank has imported: whether jax or the JAX package
    is among its modules."""
    return {"jax": "jax" in sys.modules,
            "ntt_aie_tpu": any(m == "ntt_aie_tpu" or m.startswith(
                "ntt_aie_tpu.") for m in sys.modules)}
