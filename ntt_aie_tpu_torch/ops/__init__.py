"""Column-pass kernels and the arithmetic they share."""
