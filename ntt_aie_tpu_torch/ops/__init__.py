"""Column-pass kernels and the arithmetic they share."""


def launch_counters() -> dict:
    """The kernel wrappers whose ``launches`` attribute counts the launches
    of their kernel, by kernel name (colpass, gl_colpass, fused_fourstep,
    crt, ring_layers, pointwise32). Each wrapper adds one where it launches
    its kernel and nowhere else; the column passes and the ring layers
    also keep ``launches_by``, per instantiation."""
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import crt
    from ntt_aie_tpu_torch.ops import fused_fourstep as F
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.ops import pointwise as P
    from ntt_aie_tpu_torch.ops import ring_layers as LR

    return {"colpass": C.colpass, "gl_colpass": G.gl_colpass,
            "fused_fourstep": F.fused_fourstep, "crt": crt.crt_combine,
            "ring_layers": LR.layered, "pointwise32": P.mul32}


def reset_launches() -> None:
    """Set every counter of ``launch_counters`` to 0."""
    for fn in launch_counters().values():
        fn.launches = 0
        if hasattr(fn, "launches_by"):
            fn.launches_by = {}


def read_launches() -> dict:
    """The launches counted since ``reset_launches``, by kernel name."""
    return {name: fn.launches for name, fn in launch_counters().items()}
