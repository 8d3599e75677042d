"""Causal / non-causal GQA flash attention (kernel wrapper and plain
version): ops.py."""
from repro_torch.kernels.flash_attention.ops import flash_attention
