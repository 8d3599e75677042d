"""Grouped (per-expert) matmul (kernel wrapper and plain version)."""
