"""Paged decode attention (kernel wrapper + plain version): ops.py."""
