"""Observability of the port (port of ``ntt_aie_tpu/profiling``):

- roofline — cost models (the reference's 5.5 N log2 N op model and an
  HBM roofline), the card's measured peaks and denominators, and the
  per-pass counters of a trace (``derive_trace_counters``);
- trace    — torch.profiler capture, ``record_function`` markers and the
  per-kernel summary of a Chrome trace;
- sweep    — benchmark grids to the reference's CSVs;
- plots    — the reference's figures over those CSVs (needs matplotlib);
- scaling  — the distributed plan's throughput over 1 -> D ranks.
"""

from ntt_aie_tpu_torch.profiling.roofline import (
    butterflies,
    bytes_per_transform,
    device_peaks,
    efficiency_report,
    model_ops,
)
from ntt_aie_tpu_torch.profiling.trace import capture_trace, kernel_markers

__all__ = [
    "butterflies",
    "model_ops",
    "bytes_per_transform",
    "device_peaks",
    "efficiency_report",
    "capture_trace",
    "kernel_markers",
]
