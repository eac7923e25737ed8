"""The device an entry point of the port runs on.

Every entry point (``build_plan``, ``NTTContext``, the ``make_*``
functions of ``ops``, ``gl_from_u64``, the roofline probes) takes
``device=None`` and resolves it here: None means the card,
``torch.device("cuda")``. Without a CUDA device that raises; nothing
falls back to the CPU. The plain PyTorch route on the CPU is taken only
when the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None is the CUDA device, and raises
    RuntimeError when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' for its plain PyTorch route on the CPU")
    return torch.device("cuda")
