"""Host-side UniMem page pool and the quantized-page contract."""
