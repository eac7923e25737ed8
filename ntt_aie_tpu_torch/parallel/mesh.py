"""Process meshes for the distributed four-step plan.

Port of ``ntt_aie_tpu/parallel/mesh.py``. There a mesh is a
``jax.sharding.Mesh`` over the devices of one controller; here it is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group (one process a rank: ``parallel.launch.run_spmd``,
or ``torchrun``), with the reference's axis names as its
``mesh_dim_names``, so ``mesh.get_group(name)`` is the process group of
an axis and ``dp_axis`` and ``hier_axes`` keep their meaning.

The backend is explicit and never switched on its own:

- ``nccl`` where each rank has a card of its own (the default with
  device None, the card);
- ``gloo`` on the CPU (``device="cpu"``, the default there);
- ``gloo`` with CUDA tensors where ranks share one card: NCCL refuses two
  ranks on one GPU, so ``make_mesh`` raises when NCCL is asked for with
  more ranks on the host than cards. Gloo's ``all_to_all_single`` takes
  CUDA tensors (it stages them through the host itself); its
  point-to-point ``send``/``recv`` take CPU tensors only, so no
  collective of the plan uses them.

Every rank of the default group calls a mesh builder (a mesh of fewer
ranks than the world leaves the others out: ``in_mesh``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ntt_aie_tpu_torch.utils.device import resolve_device

BACKENDS = ("nccl", "gloo")


def _default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _check_backend(backend: str, device_type: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("NCCL runs on the card: pass device=None or "
                         "'cuda', or backend='gloo' on the CPU")
    if backend == "nccl":
        ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE",
                                        dist.get_world_size()
                                        if dist.is_initialized() else 1))
        cards = torch.cuda.device_count()
        if ranks_here > cards:
            raise ValueError(
                f"NCCL takes one card a rank: {ranks_here} ranks on this "
                f"host, {cards} card(s); use backend='gloo' for ranks that "
                "share a card")


def _mesh(shape: tuple, names: tuple, device, backend) -> DeviceMesh:
    device_type = resolve_device(device).type
    backend = backend or _default_backend(device_type)
    if not dist.is_initialized():
        # torchrun's environment (MASTER_ADDR, RANK, WORLD_SIZE)
        dist.init_process_group(backend)
    elif dist.get_backend() != backend:
        raise ValueError(f"the default process group runs "
                         f"{dist.get_backend()!r}, not {backend!r}")
    _check_backend(backend, device_type)
    size = int(np.prod(shape))
    if size > dist.get_world_size():
        raise ValueError(f"need {size} ranks, have {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(size).reshape(shape),
                      mesh_dim_names=tuple(names))


def make_mesh_nd(shape: tuple, axes: tuple, *, device=None,
                 backend: str | None = None) -> DeviceMesh:
    """A mesh of any shape over the first prod(shape) ranks, row-major,
    with these axis names (e.g. (2, 2, 2) as ("dp", "dcn", "ici"): a
    data-parallel axis over a hierarchical one)."""
    if len(shape) != len(axes):
        raise ValueError(f"{len(shape)} axes of sizes {shape}, {len(axes)} "
                         f"names {axes}")
    return _mesh(tuple(shape), tuple(axes), device, backend)


def make_mesh(num_devices: int | None = None, axis: str = "x", *,
              device=None, backend: str | None = None) -> DeviceMesh:
    """A one-axis mesh over the first num_devices ranks (all of them with
    None). device: None is the card (the mesh's device type; RuntimeError
    without one), "cpu" the CPU. backend: None is nccl on the card, gloo
    on the CPU; 'gloo' with the card is the shared-card mesh."""
    if num_devices is None:
        num_devices = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh((num_devices,), (axis,), device, backend)


def make_mesh_2d(dp: int, sp: int, axes: tuple = ("dp", "x"), *,
                 device=None, backend: str | None = None) -> DeviceMesh:
    """(data-parallel batch axis, shard axis) mesh for batched distributed
    NTTs: batch rides `dp`, coefficients ride `sp`."""
    return _mesh((dp, sp), axes, device, backend)


def make_mesh_hier(groups: int, per_group: int,
                   axes: tuple = ("dcn", "ici"), *, device=None,
                   backend: str | None = None) -> DeviceMesh:
    """Two-level (major, minor) mesh for hierarchical distributed plans:
    `groups` hosts on the major axis x `per_group` cards on the minor
    axis, rank = group * per_group + index (host-major, as a multi-host
    launch numbers ranks). Pass axes to build_distributed_plan(hier_axes=)
    so the transpose collective decomposes per network tier; on one host
    it is a mode of the same bytes in two collectives."""
    return _mesh((groups, per_group), axes, device, backend)


def in_mesh(mesh: DeviceMesh) -> bool:
    """Whether this rank is one of mesh's."""
    return mesh.get_coordinate() is not None


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along the named axis."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along the named axis."""
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def shard_vector(x, mesh: DeviceMesh, axis: str = "x", *, device=None):
    """This rank's contiguous block of a flat (n,) array split over the
    mesh axis (the reference places it with P(axis)), as a tensor on
    `device` (None: the card)."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(x))
    D, d = axis_size(mesh, axis), axis_index(mesh, axis)
    m = x.shape[0] // D
    if m * D != x.shape[0]:
        raise ValueError(f"{x.shape[0]} values do not split over {D} ranks")
    return x[d * m:(d + 1) * m].to(device)
