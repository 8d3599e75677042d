"""Host-side UniMem page pool and the quantized-page contract; the
paper's analytic chip models (datapath, hwmodel, projection, simulator)."""
