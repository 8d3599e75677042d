"""Mamba-2 SSD intra-chunk dual form (kernel wrapper and plain version)."""
from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk
