"""Scripts of the port, run as ``python -m ntt_aie_tpu_torch.scripts.<name>``."""
