"""Benchmarks of the port (counterpart of kungfu_tpu.benchmarks); only the
fused computation-collective benchmark is ported (`--bench fused`)."""
