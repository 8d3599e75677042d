"""Paged chunk-prefill attention (kernel wrapper + plain version): ops.py."""
