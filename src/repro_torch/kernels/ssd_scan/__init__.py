"""Mamba-2 SSD intra-chunk dual form (kernel wrapper and plain version)."""
