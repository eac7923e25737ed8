"""Run a function on every rank of a process group: the port's SPMD
launcher.

The reference is single-controller: one process drives every device of a
``jax.sharding.Mesh`` under ``shard_map``. PyTorch runs one process a
rank, so the port spawns them (``run_spmd``) with the ``spawn`` start
method (never ``fork`` once CUDA is up), joins them into one default
process group over a ``FileStore`` in a fresh temporary directory, and
hands each rank's return value back to the caller. On a machine with a
card a rank, ``torchrun`` with ``backend='nccl'`` does the same job
(``parallel.mesh.make_mesh`` then initializes the group from its
environment).

The function a rank runs must be importable by name in a fresh
interpreter (a module-level function of an importable module): the spawn
start method re-imports the module that holds it in every child.
"""

from __future__ import annotations

import pathlib
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn, world: int, backend: str, device_type: str,
               tmp: str) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    args = torch.load(tmp / "args.pt", weights_only=False)
    dist.init_process_group(backend,
                            store=dist.FileStore(str(tmp / "store"), world),
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_spmd(fn, world: int, *, backend: str, device_type: str,
             args: tuple = ()) -> list:
    """Run fn(rank, world, *args) on `world` spawned ranks of one default
    process group (`backend`: 'gloo' or 'nccl') and return their results,
    rank 0 first (each saved with torch.save in the rank and loaded here
    onto the CPU). device_type 'cuda' sets rank r's current card to
    r mod the card count (the ranks share one card where there is one);
    'cpu' ranks run one intra-op thread each. A rank that raises makes
    run_spmd raise (torch.multiprocessing's ProcessRaisedException, with
    the rank's traceback), and the other ranks are stopped. args travel
    to the ranks through a file (torch.save), not the spawn pipe."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    with tempfile.TemporaryDirectory() as tmp:
        # the arguments go through a file: a spawned child reads its pipe
        # only once it has imported torch, so a large pickle there would
        # start the ranks one after another
        torch.save(tuple(args), pathlib.Path(tmp) / "args.pt")
        mp.start_processes(
            _rank_main, nprocs=world, join=True, start_method="spawn",
            args=(fn, world, backend, device_type, tmp))
        return [torch.load(pathlib.Path(tmp) / f"rank{r}.pt",
                           map_location="cpu", weights_only=False)
                for r in range(world)]
