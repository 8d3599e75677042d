"""Split-KV decode attention over a contiguous cache (kernel wrapper,
plain version and the split combine): ops.py."""
