"""The four-step NTT sharded over ranks, one process a rank.

Port of the reference's ``examples/distributed_demo.py``. The reference
drives every device of a mesh from one process; here
``parallel.launch.run_spmd`` spawns one rank a card (NCCL), or ranks on
the CPU (gloo), and every rank runs ``demo_rank``: the n = 2^16 round
trip on the flat mesh with the transpose in two chunks, the negacyclic
product on the mesh, a small single-device product against the
schoolbook oracle, the hierarchical (2 x D/2) mesh's spectrum against the
flat mesh's, and the exact RNS product over the mesh against the
single-device one.

    python -m ntt_aie_tpu_torch.examples.distributed_demo [--device cpu]

On the card it takes as many ranks as there are cards (the largest power
of two); ranks that share one card need backend='gloo' (``run(world=4,
backend="gloo")``), which is no multi-chip figure.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ntt_aie_tpu_torch.examples import parse_args, report, require
from ntt_aie_tpu_torch.fields import P_469762049 as FIELD
from ntt_aie_tpu_torch.ops import read_launches, reset_launches
from ntt_aie_tpu_torch.utils.device import resolve_device

N_LOG2 = 16
CPU_WORLD = 4  # the smallest world that runs the hierarchical branch


def demo_rank(rank: int, world: int, log_n: int, device_type: str) -> dict:
    """The whole demo on one rank of run_spmd's group (every rank builds
    every mesh and plan and takes the same seeded inputs). Rank 0 returns
    the gathered outputs and its lines, every rank its kernel launches
    (counted from 0 at its start)."""
    from ntt_aie_tpu_torch import reference as ref
    from ntt_aie_tpu_torch.api import NTTContext
    from ntt_aie_tpu_torch.config import NTTConfig
    from ntt_aie_tpu_torch.parallel.fourstep import build_distributed_plan
    from ntt_aie_tpu_torch.parallel.mesh import make_mesh, make_mesh_hier
    from ntt_aie_tpu_torch.rns import RNSPolymul

    device = torch.device(device_type)
    reset_launches()
    D, lines = world, []
    cfg = NTTConfig(field=FIELD, log_n=log_n, rows_log2=log_n // 2,
                    num_shards=D, negacyclic=True)
    mesh = make_mesh(D, device=device,
                     backend=torch.distributed.get_backend())
    # overlap_chunks=2: the transpose's exchange in two chunks, each
    # chunk's pass 2 free to run while the next flies (bit-identical to
    # one exchange)
    chunks = 2 if cfg.split[0] % (2 * D) == 0 else 1
    plan = build_distributed_plan(cfg, mesh, device=device,
                                  overlap_chunks=chunks)

    rng = np.random.default_rng(0)
    a = rng.integers(0, FIELD.p, cfg.n)
    spec = plan.fwd(plan.shard_input(a))          # C exchanges
    back = plan.gather(plan.inv(spec)).reshape(-1).cpu().numpy()
    require(np.array_equal(back, a), "the mesh round trip differs")
    lines.append(f"n=2^{log_n} four-step NTT over {D} rank(s) "
                 f"(overlap_chunks={chunks}): roundtrip ✓")

    # the RLWE X^n + 1 product on the same mesh (psi rides the passes)
    b = rng.integers(0, FIELD.p, cfg.n)
    c = plan.gather(plan.negacyclic_polymul(
        plan.shard_input(a), plan.shard_input(b))).reshape(-1)
    require(int(c.max()) < FIELD.p, "the mesh product is not canonical")
    # the oracle check at a reduced size (the O(n^2) schoolbook is too
    # slow at 2^16; the mesh path itself is held in the tests)
    small = NTTConfig(field=FIELD, log_n=9, num_shards=1, negacyclic=True)
    sa, sb = a[: 1 << 9] % FIELD.p, b[: 1 << 9] % FIELD.p
    sgot = NTTContext(small, device=device).negacyclic_polymul(sa, sb)
    require(np.array_equal(sgot.cpu().numpy().astype(np.int64),
                           ref.schoolbook_negacyclic(sa, sb, FIELD.p)
                           .astype(np.int64)),
            "the n = 2^9 product differs from the schoolbook")
    lines.append(f"negacyclic polymul over {D} rank(s): ✓ "
                 "(oracle-checked at n=2^9)")

    # the hierarchical (major x minor) mesh: the transpose in two
    # exchanges, one a tier, bit-identical to the flat plan
    flat_spec = plan.gather(spec)
    hspec = None
    if D >= 4:
        hmesh = make_mesh_hier(2, D // 2, device=device,
                               backend=torch.distributed.get_backend())
        hplan = build_distributed_plan(cfg, hmesh, device=device,
                                       hier_axes=("dcn", "ici"))
        hspec = hplan.gather(hplan.fwd(hplan.shard_input(a)))
        require(torch.equal(hspec, flat_spec),
                "the hierarchical spectrum differs from the flat one")
        lines.append(f"hierarchical 2x{D // 2} (dcn x ici) mesh: two-phase "
                     "transpose bit-identical to flat ✓")

    # the exact big-integer product over the mesh through RNS and CRT
    rns = RNSPolymul(10, mesh=mesh, device=device)
    big_a = np.array([int(x) for x in rng.integers(0, 1 << 38, 1 << 10)],
                     dtype=object)
    big_b = np.array([int(x) for x in rng.integers(0, 1 << 38, 1 << 10)],
                     dtype=object)
    got = rns.polymul(big_a, big_b)
    single = RNSPolymul(10, device=device).polymul(big_a, big_b)
    require(np.array_equal(got, single),
            "the mesh RNS product differs from the single-device one")
    lines.append(f"RNS big-int polymul over {D} rank(s): exact ✓")

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = read_launches()
    if rank != 0:
        return {"launches": launches}

    def host(t):
        return None if t is None else t.cpu().numpy()

    return {"launches": launches, "a": a, "b": b, "spec": host(flat_spec),
            "back": back, "negacyclic": host(c), "small": (sa, sb,
                                                           host(sgot)),
            "hier_spec": host(hspec), "big_a": big_a, "big_b": big_b,
            "rns": got, "lines": lines}


def run(log_n: int = N_LOG2, *, world: int | None = None,
        backend: str | None = None, device=None) -> dict:
    """The demo on `world` spawned ranks (None: on the card the largest
    power of two of cards, on the CPU CPU_WORLD) over `backend` (None:
    nccl on the card, gloo on the CPU; gloo for ranks that share a card).
    Returns rank 0's outputs with "launches" summed over the ranks,
    "world" and "backend"."""
    from ntt_aie_tpu_torch.parallel.launch import run_spmd

    device = resolve_device(device)
    if world is None:
        count = (torch.cuda.device_count() if device.type == "cuda"
                 else CPU_WORLD)
        world = 1 << (count.bit_length() - 1)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    res = run_spmd(demo_rank, world, backend=backend,
                   device_type=device.type, args=(log_n, device.type))
    out = dict(res[0], world=world, backend=backend)
    out["launches"] = {k: sum(r["launches"][k] for r in res)
                       for k in res[0]["launches"]}
    return out


def main(argv=None) -> int:
    args = parse_args(argv, __doc__)
    return report(run(device=args.device))


if __name__ == "__main__":
    sys.exit(main())
