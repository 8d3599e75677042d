"""Grouped (per-expert) matmul (kernel wrapper and plain version)."""
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
