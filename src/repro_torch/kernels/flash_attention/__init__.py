"""Causal / non-causal GQA flash attention (kernel wrapper and plain
version): ops.py."""
