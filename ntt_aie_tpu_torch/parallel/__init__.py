"""The distributed four-step plan on torch.distributed (port of
``ntt_aie_tpu.parallel``): ``mesh`` (process meshes), ``launch`` (the SPMD
launcher) and ``fourstep`` (the 32-bit and Goldilocks plans, the pairwise
mode), and ``runs`` (the rank functions that drive them)."""

from ntt_aie_tpu_torch.parallel import fourstep, launch, mesh, runs  # noqa: F401,E402
