"""ntt_aie_tpu_torch — the NTT framework on PyTorch, with CUDA kernels for
NVIDIA Hopper.

A port of ``ntt_aie_tpu`` (the JAX/Pallas reference, which stays the
oracle). It imports torch and numpy and never jax. Ported so far:

- the four-step fold plan over the 32-bit fields under every reduction
  (harvey4 p < 2^29, harvey p < 2^30, montgomery odd p < 2^31, barrett
  p < 2^14; ``NTTConfig.reduction``) and over Goldilocks
  (p = 2^64 - 2^32 + 1, as (hi, lo) limb planes), each column pass a
  hand-written CUDA kernel (``ops/colpass.py`` and ``csrc/colpass.cu``;
  ``ops/gl_colpass.py`` and ``csrc/gl_colpass.cu``) with its plain
  PyTorch version on the CPU; for the 32-bit fields its ``wmat_fold=False``
  arm and its negacyclic product, whose psi scalings ride the column
  passes as 'pre' and 'post' operands;
- for the 32-bit fields the fused plan (``build_plan(..., fused=True)``:
  one launch of ``csrc/fused_fourstep.cu`` a transform,
  ``ops/fused_fourstep.py``) with its negacyclic product;
- the flat split (``NTTConfig.split`` = (n, 1), the default for a single
  shard up to n = 2^16, 2^14 for Goldilocks), which runs these kernels at
  an internal split and gathers into bit-reversed order, its plain
  version the reference's stage loops (``ops/stages.py``);
- exact big-integer products: ``RNSPolymul`` (``rns.py``) over several
  word primes, recombined by ``make_crt_combine`` (``ops/crt.py``, the
  CUDA kernel ``csrc/crt.cu``) into uint32 limbs, ``limbs_to_int`` on
  the host;
- n = 2 on the flat split (``plan.flat_n2_plan``: its one butterfly as
  torch ops, as the reference's flat stage loops) and the reference-parity
  convention (``NTTConfig(table_convention='reference')``: the reference
  device's network and 16-block layout, ``ops.stages
  .reference_network_stages``);
- the FIPS 203/204 rings: ML-KEM (``kyber``) and ML-DSA (``dilithium``)
  transforms, products, module-lattice matvec and serving pipelines
  (``make_pipeline``), each call one launch of a kernel of
  ``csrc/ring_layers.cu`` (``ops/ring_layers.py``: ``layered`` and the
  fused ``ring_product``; the plain versions ``layered_plain`` and
  ``ring_product_plain``);
- the distributed four-step plan on torch.distributed (``parallel``:
  ``mesh`` builds DeviceMeshes with an explicit backend, ``launch.run_spmd``
  spawns the ranks, ``fourstep`` the 32-bit and Goldilocks plans with
  chunked, dp-batched and hierarchical transposes, and the pairwise
  mode), behind ``NTTContext(mesh=)`` and ``RNSPolymul(mesh=)``;
- the round-4 nested R x S column pass (``ops/nested_colpass.py``,
  ``csrc/nested_colpass.cu``, run by ``scripts/proto_nested_colpass.py``)
  and the roofline probes (``profiling/roofline.py``,
  ``csrc/bfly_probe.cu``);
- observability: torch.profiler traces with per-pass counters
  (``profiling/trace.py``, ``roofline.derive_trace_counters``), device
  and host-dispatch timing (``utils/timing.py``), the sweep, plot and
  scaling harnesses (``profiling/sweep.py``, ``plots.py``,
  ``scaling.py``);
- the command line, ``python -m ntt_aie_tpu_torch
  info|verify|bench|sweep|trace|scaling|plot`` (``cli.py``), and host
  streaming that overlaps copies with compute
  (``utils/streaming.stream_transform``).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from ntt_aie_tpu_torch.fields import (  # noqa: F401
    DILITHIUM,
    FIELDS,
    GOLDILOCKS,
    KYBER,
    P_469762049,
    P_998244353,
    P_2013265921,
    PrimeField,
)
from ntt_aie_tpu_torch.config import NTTConfig  # noqa: F401
from ntt_aie_tpu_torch.plan import Plan, build_plan  # noqa: F401
from ntt_aie_tpu_torch.goldilocks_plan import build_goldilocks_plan  # noqa: F401
from ntt_aie_tpu_torch.api import NTTContext  # noqa: F401
from ntt_aie_tpu_torch.rns import RNSPolymul  # noqa: F401
from ntt_aie_tpu_torch.ops.crt import limbs_to_int, make_crt_combine  # noqa: F401
from ntt_aie_tpu_torch import dilithium, kyber, parallel, ring_layers  # noqa: F401

__version__ = "0.1.0"
